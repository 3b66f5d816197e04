"""Where the persistent compilation cache is placed."""

import os
import subprocess
import sys

from mpas_ocean.utils.compile_cache import CACHE_ENV, cache_dir

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_environment():
    assert cache_dir({CACHE_ENV: "/some/shared/cache"}) == "/some/shared/cache"


def test_cache_dir_defaults_to_checkout_root():
    # a fixed path, never built from a temporary name, pid or time
    assert cache_dir({}) == os.path.join(ROOT, ".jax_cache")
    assert cache_dir({CACHE_ENV: ""}) == os.path.join(ROOT, ".jax_cache")


def test_enable_sets_jax_config_only_without_env(tmp_path):
    code = (
        "import jax\n"
        "from mpas_ocean.utils.compile_cache import enable_compile_cache\n"
        "print(enable_compile_cache())\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != CACHE_ENV}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    want = os.path.join(ROOT, ".jax_cache")
    assert r.stdout.split() == [want, want]

    env[CACHE_ENV] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [str(tmp_path), str(tmp_path)]
