"""Where the persistent compile cache goes (utils/jaxcfg.enable_cache)."""
import os

import jax
import pytest

from svscope_tpu.utils import jaxcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_cache_dir_is_fixed_in_the_checkout():
    assert jaxcfg.CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()


@pytest.mark.parametrize("case", ["env_set", "env_unset", "cache_off"])
def test_enable_cache(tmp_path, monkeypatch, case):
    """JAX_COMPILATION_CACHE_DIR set: JAX reads it itself and nothing is
    set here.  Unset: the fixed directory.  Cache turned off (as this test
    suite does): nothing at all."""
    fixed = tmp_path / "fixed"
    monkeypatch.setattr(jaxcfg, "CACHE_DIR", str(fixed))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    if case == "env_set":
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
    old = (jax.config.jax_enable_compilation_cache,
           jax.config.jax_compilation_cache_dir)
    try:
        jax.config.update("jax_enable_compilation_cache", case != "cache_off")
        jax.config.update("jax_compilation_cache_dir", None)
        jaxcfg.enable_cache()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_enable_compilation_cache", old[0])
        jax.config.update("jax_compilation_cache_dir", old[1])
    if case == "env_unset":
        assert got == str(fixed) and fixed.is_dir()
    else:
        assert got is None and not fixed.exists()
