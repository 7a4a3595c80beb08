"""The GPU entry scripts refuse to run without a GPU, and the compile cache
lands where the program says.

``chip_smoke.py`` and ``bench.py`` measure the card; on a machine without
one they must fail and print no result rather than time the CPU.
"""

import importlib
import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env_extra=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script,args", [("chip_smoke.py", []),
                                         ("chip_smoke.py", ["--four-cards"]),
                                         ("bench.py", [])])
def test_script_fails_without_gpu(script, args):
    res = _run([os.path.join(REPO, script), *args], REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "ticks_per_sec" not in res.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run(["chip_smoke.py"], str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _fresh_cache_module():
    from shermbot_navigation.utils import compile_cache
    return importlib.reload(compile_cache)


def test_compile_cache_defaults_into_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        cc = _fresh_cache_module()
        path = cc.enable()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # a fixed path: enabling again gives the same directory
        assert cc.enable() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_the_variable(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        cc = _fresh_cache_module()
        assert cc.enable() == str(tmp_path)
        # nothing set in code: the config keeps what JAX read itself
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_gitignore_lists_the_cache():
    lines = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in lines
