from .checkpoint import load_amps, save_amps
from .compile_cache import cache_dir, setup_compile_cache
from .synth import mp2_guess, synthetic_hamiltonian
from .timing import Timers, timers, trace

__all__ = ["synthetic_hamiltonian", "mp2_guess", "save_amps", "load_amps",
           "Timers", "timers", "trace", "cache_dir",
           "setup_compile_cache"]
