"""The accelerator a measurement runs on: the GPU gate, the card's name
and power limit, and the published peak rates a measured rate is divided
by.

A measurement that finds no GPU fails; it never falls back to the CPU.
"""

import subprocess

# Dense peak FLOP/s by JAX device_kind and dtype, from NVIDIA's H100
# Tensor Core GPU data sheet (SXM5 part, without sparsity; at the 700 W
# power limit): bf16 and TF32 on the tensor cores, f32 outside them, f64
# on the tensor cores.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {
        "bfloat16": 989e12,
        "tf32": 495e12,
        "float32": 67e12,
        "float64": 67e12,
    },
}


def require_gpu(devices):
    """The first device, if it is a GPU; otherwise raise naming the
    backend JAX found."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError("a GPU is required, but JAX's backend is %r (%s)"
                           % (dev.platform, dev.device_kind))
    return dev


def peak_flops(device_kind, dtype):
    """Published dense peak of `device_kind` in `dtype` ('bfloat16',
    'tf32', 'float32', 'float64'); an unknown device or dtype raises."""
    try:
        return PEAK_FLOPS[device_kind][dtype]
    except KeyError:
        raise KeyError("no published peak for %r in %s (known: %s)"
                       % (device_kind, dtype, sorted(PEAK_FLOPS))) from None


def card_info():
    """Name and power limit of every card, as `nvidia-smi` reports them.
    Runs as a child process, which does not touch JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())
