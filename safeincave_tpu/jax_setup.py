"""Global JAX configuration for safeincave_tpu.

The reference solver (SafeInCave) runs float64 end-to-end
(/root/reference/safeincave/Utils.py:248, MaterialProps.py:74-78); the 1e-8
field-parity target requires f64, so we enable x64 at import time, before any
tracing happens.
"""
import os

import jax

jax.config.update("jax_enable_x64", True)

# Full-precision f32 contractions.  On the GPU, XLA's DEFAULT precision lets
# f32 matmuls and einsums run in TF32 (~10 mantissa bits); the f32 Krylov
# path needs true f32 arithmetic (BiCGStab breaks down near the TF32 noise
# floor), so force full-precision accumulation for all einsum/dot lowering.
jax.config.update("jax_default_matmul_precision", "highest")


# Persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set, else
# .jax_cache inside the checkout (a fixed path, since the path is part of
# the cache key).
def _default_cache_dir():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(repo, ".jax_cache")


CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _default_cache_dir()
jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

DTYPE = "float64"
