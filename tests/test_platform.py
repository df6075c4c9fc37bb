"""Device-facing helpers: the peak-rate table, the compile-cache location,
the pytree dataclasses, the stdlib PNG codec and chip_smoke's refusal to
run without a GPU."""

import dataclasses
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pbrpathtracer_tpu.io.png import read_png, write_png
from pbrpathtracer_tpu.utils import compile_cache, roofline
from pbrpathtracer_tpu.utils.pytree import pytree_dataclass, static_field

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- peak table ------------------------------------------------------------

def test_h100_peaks_resolve():
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert p.bf16_flops == 989e12 and p.hbm_bytes_per_s == 3.35e12
    assert p.fp32_flops == 67e12 and p.tf32_flops == 495e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "unknown"])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no peak rates"):
        roofline.peaks(kind)


def test_roofline_bound():
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    hbm = roofline.build(p, bytes_accessed=3.35e12, xla_flops=1.0)
    assert hbm.bound == "hbm" and hbm.t_roofline_s == pytest.approx(1.0)
    fp = roofline.build(p, 1.0, 67e12, roofline.pallas_pair_flops(1, 1, 1))
    assert fp.bound == "fp32" and fp.t_roofline_s > 1.0
    assert fp.fraction(2 * fp.t_roofline_s) == pytest.approx(0.5)


# ---- compile cache ---------------------------------------------------------

def test_compile_cache_honours_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


# ---- pytree dataclasses ----------------------------------------------------

@pytree_dataclass
class _Thing:
    a: jnp.ndarray
    b: object = None
    n: int = static_field(3)


def test_pytree_flatten_unflatten_replace():
    t = _Thing(a=jnp.ones(2), b=jnp.zeros(3), n=5)
    leaves, tree = jax.tree_util.tree_flatten(t)
    assert len(leaves) == 2                      # n is static metadata
    back = jax.tree_util.tree_unflatten(tree, leaves)
    assert back.n == 5 and np.array_equal(back.b, t.b)
    r = t.replace(n=7)
    assert r.n == 7 and t.n == 5 and r.a is t.a
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.n = 1
    assert len(jax.tree_util.tree_leaves(_Thing(a=jnp.ones(1)))) == 1


def test_pytree_static_field_keys_the_jit_cache():
    traces = []

    @jax.jit
    def f(t):
        traces.append(t.n)
        return t.a * t.n

    x = jnp.ones(2)
    assert float(f(_Thing(a=x, n=2))[0]) == 2.0
    assert float(f(_Thing(a=x + 1, n=2))[0]) == 4.0   # same key: no retrace
    assert float(f(_Thing(a=x, n=3))[0]) == 3.0       # new static: retrace
    assert traces == [2, 3]


def test_scene_types_are_pytrees():
    from pbrpathtracer_tpu.scene.builders import cornell_box
    from pbrpathtracer_tpu.scene.big_scenes import mesh_scene
    s = cornell_box()
    leaves, tree = jax.tree_util.tree_flatten(s)
    again = jax.tree_util.tree_unflatten(tree, leaves)
    assert again.has_translucent == s.has_translucent
    assert again.num_triangles == s.num_triangles
    m = mesh_scene(600, accel="always")
    assert m.accel.leaf_size == 8
    assert m.replace(accel=None).accel is None


# ---- PNG ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (64, 48)])
def test_png_roundtrip(tmp_path, shape):
    rs = np.random.RandomState(shape[0])
    img = rs.randint(0, 256, shape + (3,)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(read_png(path), img)


def _png(path, w, h, ctype, raw):
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,ch,ftype", [(6, 4, 0), (0, 1, 0), (2, 3, 1)])
def test_png_reader_refuses_other_formats(tmp_path, ctype, ch, ftype):
    """RGBA, gray, or a scanline filter other than 0: not what write_png
    writes, so read_png refuses rather than misreads it."""
    w, h = 9, 4
    raw = b"".join(bytes([ftype]) + bytes(w * ch) for _ in range(h))
    path = str(tmp_path / "f.png")
    _png(path, w, h, ctype, raw)
    with pytest.raises(ValueError):
        read_png(path)


def test_export_png_tonemaps(tmp_path):
    from pbrpathtracer_tpu.io.png import export_png
    img = np.array([[[0.0, 0.5, 2.0]]], np.float32)
    path = export_png(str(tmp_path / "e.png"), img)
    np.testing.assert_array_equal(read_png(path), [[[0, 127, 255]]])


def test_cli_fit_reads_png_target(tmp_path, capsys):
    from pbrpathtracer_tpu import cli
    target = str(tmp_path / "t.png")
    write_png(target, np.full((6, 8, 3), 90, np.uint8))
    cli.main(["fit", "--builtin", "cornell", "--width", "8", "--height", "6",
              "--depth", "1", "--spp", "1", "--steps", "1",
              "--target", target])
    assert "final loss" in capsys.readouterr().out


# ---- chip_smoke ----------------------------------------------------------------

def test_chip_smoke_refuses_cpu():
    """With no GPU the smoke test exits non-zero and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_device_phase_in_process():
    sys.path.insert(0, REPO)
    import chip_smoke
    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.phase_device(1)
