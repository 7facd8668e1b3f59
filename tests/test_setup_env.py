"""Process set-up: the compile-cache directory and the optional h5py."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code, **env_changes):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k, v in env_changes.items():
        if v is None:
            env.pop(k, None)
        else:
            env[k] = v
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


_CACHE = ("import jax, safeincave_tpu.jax_setup as s; "
          "print(s.CACHE_DIR == jax.config.jax_compilation_cache_dir, "
          "s.CACHE_DIR)")


def test_compile_cache_follows_env(tmp_path):
    out = _python(_CACHE, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert out == f"True {tmp_path}"


def test_compile_cache_defaults_inside_checkout():
    out = _python(_CACHE, JAX_COMPILATION_CACHE_DIR=None)
    assert out == f"True {os.path.join(ROOT, '.jax_cache')}"


def test_import_without_h5py():
    out = _python("import sys; sys.modules['h5py'] = None; "
                  "import safeincave_tpu as sc; "
                  "print('h5py' in sys.modules and "
                  "sys.modules['h5py'] is None, sc.Simulator_M.__name__)")
    assert out == "True Simulator_M"


def test_xdmf_output_names_h5py_when_missing(monkeypatch, tmp_path):
    from safeincave_tpu import postproc
    from safeincave_tpu.output import xdmf
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        xdmf.require_h5py()
    with pytest.raises(ImportError, match="h5py"):
        postproc.read_timeseries(str(tmp_path), "u")
