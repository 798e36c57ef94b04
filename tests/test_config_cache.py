"""Where the persistent XLA compilation cache goes, checked in a fresh
interpreter (the choice is made when mad_tpu.core.config is imported)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = ("import json, jax, mad_tpu.core.config as c; "
         "print(json.dumps([jax.config.jax_compilation_cache_dir, "
         "c.cache_root(), c.xla_cache_dir()]))")


def _probe(**env_over):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                        "MAD_TPU_CACHE")}
    env.update(env_over)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", ["default", "env_dir", "cpu"])
def test_compile_cache_placement(case, tmp_path):
    fixed = os.path.join(ROOT, ".jax_cache")
    if case == "default":
        # No variable set: one fixed directory inside the checkout, the
        # same in every process.
        jax_dir, root, xla = _probe()
        assert root == fixed
        assert jax_dir == xla == os.path.join(fixed, "xla")
        assert _probe()[0] == jax_dir
    elif case == "env_dir":
        # JAX_COMPILATION_CACHE_DIR set: JAX uses it and the program sets
        # no other directory.
        want = str(tmp_path / "xla_cache")
        jax_dir, root, xla = _probe(JAX_COMPILATION_CACHE_DIR=want)
        assert jax_dir == xla == want
        assert root == fixed
    else:
        # CPU runs keep no persistent XLA cache.
        jax_dir, _root, _xla = _probe(JAX_PLATFORMS="cpu")
        assert not jax_dir
