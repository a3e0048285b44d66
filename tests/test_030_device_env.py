"""The GPU gate, the peak table, the compile-cache location and the
native build key: what decides where and how the program runs, checked on
the CPU."""

import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import pytest

from pycc_tpu.scf import native
from pycc_tpu.utils import compile_cache
from pycc_tpu.utils.device import PEAK_FLOPS, peak_flops, require_gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@pytest.mark.parametrize("module", ["chip_smoke", "bench"])
def test_entry_points_refuse_cpu(module, capsys):
    """chip_smoke and bench stop on a CPU backend, name it, and print no
    result."""
    mod = __import__(module)
    args = ([],) if module == "chip_smoke" else ()
    with pytest.raises(RuntimeError, match="backend is 'cpu'"):
        mod.main(*args)
    assert capsys.readouterr().out == ""


def test_require_gpu():
    gpu = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert require_gpu([gpu]) is gpu
    with pytest.raises(RuntimeError, match="cpu"):
        require_gpu(jax.devices("cpu"))


def test_peak_table():
    h100 = "NVIDIA H100 80GB HBM3"
    assert peak_flops(h100, "bfloat16") == 989e12
    assert peak_flops(h100, "tf32") == 495e12
    assert set(PEAK_FLOPS[h100]) == {"bfloat16", "tf32", "float32",
                                     "float64"}
    with pytest.raises(KeyError, match="no published peak"):
        peak_flops("cpu", "float32")
    with pytest.raises(KeyError):
        peak_flops(h100, "int4")


def test_bench_row_share_uses_its_own_dtype():
    import bench
    card = {"device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                       "count": 1}, "card": "NVIDIA H100 80GB HBM3, 700.00 W"}
    row = bench._row("m", 2.0, 2.0 * 67e12, "float32", card)
    assert row["share_of_float32_peak"] == 1.0
    assert row["device"]["kind"] == card["device"]["kind"]
    assert row["card"] == card["card"]
    row = bench._row("m", 1.0, 989e12 / 2, "bfloat16", card)
    assert row["share_of_bfloat16_peak"] == 0.5


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in [n for n, _ in calls]

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    calls.clear()
    path = compile_cache.setup_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert ("jax_compilation_cache_dir", path) in calls


def test_cache_dir_same_from_any_cwd(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", "from pycc_tpu.utils.compile_cache import "
         "cache_dir; print(cache_dir())"],
        cwd=tmp_path, env=env, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == os.path.join(ROOT, ".jax_cache")


def test_native_build_key():
    src, cxx, cpu = b"int f() { return 1; }", "g++ 13", "x86_64 flags: avx2"
    key = native.build_key(src, cxx, cpu)
    assert key == native.build_key(src, cxx, cpu)
    assert key != native.build_key(src, cxx, cpu + " avx512f")
    assert key != native.build_key(src, "g++ 14", cpu)
    assert key != native.build_key(b"int f() { return 2; }", cxx, cpu)


def test_native_build_rebuilds_for_another_host(tmp_path):
    """A library built for one CPU is never loaded on another: the other
    host's key names a fresh build, and an existing build is reused."""
    src = tmp_path / "k.cpp"
    src.write_text('extern "C" int f() { return 1; }\n')
    build = tmp_path / "build"
    so_a = native.build(str(src), str(build), cpu="host A")
    mtime = os.path.getmtime(so_a)
    assert native.build(str(src), str(build), cpu="host A") == so_a
    assert os.path.getmtime(so_a) == mtime
    so_b = native.build(str(src), str(build), cpu="host B")
    assert so_b != so_a and os.path.exists(so_b)
    src.write_text('extern "C" int f() { return 2; }\n')
    so_c = native.build(str(src), str(build), cpu="host A")
    assert so_c not in (so_a, so_b) and os.path.exists(so_c)
    assert sorted(os.listdir(build)) == sorted(
        os.path.basename(os.path.dirname(p)) for p in (so_a, so_b, so_c))


def test_native_engine_builds_here():
    assert native.available()
    assert native.build().startswith(os.path.join(ROOT, "native", "build"))


def test_chip_smoke_phases_small_on_cpu(monkeypatch, capsys):
    """chip_smoke's phase-2 and phase-3 code at a tiny size (H2O/STO-3G)
    on the CPU: the same checks, the same printed lines."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "MOLECULE", "H2O")
    monkeypatch.setattr(chip_smoke, "BASIS", "sto-3g")
    dev = jax.devices("cpu")[0]
    cc, e_dp = chip_smoke.phase2(dev, dev)
    chip_smoke.phase3(dev, cc, e_dp)
    out = capsys.readouterr().out
    for tag in ("phase 2 prep", "phase 2 residual", "phase 2 CCSD(T)",
                "phase 2 Lambda", "phase 2 density",
                "phase 3 SP (default", "phase 3 SP (highest"):
        assert tag in out, tag
    assert abs(e_dp - -0.070616830152761) < 1e-6   # DF at df_tol 1e-6


def test_chip_smoke_mesh_phase_on_cpu_devices(monkeypatch, capsys):
    """The --gpus 4 phase on four virtual CPU devices (H2O/aug-cc-pVDZ,
    nv = 36 splits 2x2): Bvv and t2 sharded, mesh == one device."""
    import chip_smoke
    monkeypatch.setattr(chip_smoke, "MOLECULE", "H2O")
    monkeypatch.setattr(chip_smoke, "BASIS", "aug-cc-pvdz")
    chip_smoke.phase_mesh(jax.devices("cpu")[:4])
    out = capsys.readouterr().out
    assert "Bvv global (356, 36, 36) shard (356, 18, 18)" in out
    assert "t2 global (4, 4, 36, 36) shard (4, 4, 18, 18)" in out
    assert "phase 4 mesh" in out
    with pytest.raises(RuntimeError, match="needs four GPUs"):
        chip_smoke.phase_mesh(jax.devices("cpu")[:2])
