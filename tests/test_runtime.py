"""Process-level behaviour: where compiled programs persist, how the native
host library is keyed, and what a fresh decode process measures."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _python(code: str, env_update: dict, drop=()) -> str:
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_update)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [REPO, env.get("PYTHONPATH")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


@pytest.mark.parametrize("where", ["env_set", "env_unset"])
def test_compile_cache_location(where, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    one fixed path inside the checkout that git ignores."""
    code = ("import jax, vc2tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    drop = ("VC2TPU_NO_COMPILE_CACHE", "JAX_COMPILATION_CACHE_DIR")
    if where == "env_set":
        want = str(tmp_path / "cache")
        got = _python(code, {"JAX_PLATFORMS": "cpu",
                             "JAX_COMPILATION_CACHE_DIR": want}, drop)
        assert got == want
    else:
        got = _python(code, {"JAX_PLATFORMS": "cpu"}, drop)
        assert got == os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_fresh_decode_process_measures_the_link():
    """A decode-only process that has not touched the backend yet still
    measures the device fetch (no route taken by forfeit)."""
    code = (
        "import math\n"
        "from jax._src import xla_bridge\n"
        "from vc2tpu.cli.decode_stream import Decoder\n"
        "assert not xla_bridge._backends, 'backend already initialised'\n"
        "s = Decoder(sink=None)._probe_link_seconds(1 << 16)\n"
        "assert math.isfinite(s) and s >= 0, s\n"
        "print(s)\n")
    float(_python(code, {"JAX_PLATFORMS": "cpu"}))


def test_native_library_keyed_by_host():
    """A native library built on another CPU or from other source never
    loads: its file name carries both."""
    from vc2tpu._native import bridge

    a, b = bridge._so_path("cpu A"), bridge._so_path("cpu B")
    assert a != b and a == bridge._so_path("cpu A")
    assert os.path.basename(a).startswith("libvc2host-")
    if bridge.native is not None:
        assert os.path.exists(bridge._so_path())
