"""The port's ``raster`` command against the JAX package's.

Both modules' resolver construction is replaced by the same deterministic
stand-in (``tests/test_torch_port_tiling._det_sr``, with and without a
moments hook), so the windowing, the normalization, the streamed sweep, the
resume journal and the TIFF writers are what is compared: the port's and
JAX's ``raster.main`` must write byte-equal files. One run serves a real
tiny Cond_SRVAE from a port checkpoint on the CPU.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from simple_vae_rs_tpu import raster as jraster
from simple_vae_rs_tpu import serve as jserve
from simple_vae_rs_tpu import tiling as jtiling
from simple_vae_rs_tpu.data import tiffio as jtiffio

from simple_vae_rs_tpu_torch import raster, tiling
from simple_vae_rs_tpu_torch.data import tiffio
from simple_vae_rs_tpu_torch.data.tiffio import read_tiff, write_tiff
from tests.test_torch_port_tiling import WIN, _det_moments, _det_sr, tiny_pair
from tests.test_torch_port_tiling import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stand_in(base, as_tensor, moments=True, channels=4):
    wrap = (lambda a: torch.from_numpy(np.ascontiguousarray(a))) if as_tensor else (lambda a: a)

    class StandIn(base):
        window, normalize = WIN, True
        model = types.SimpleNamespace(config=types.SimpleNamespace(channels=channels))

        def super_resolve(self, y, normalize=None, seed=None):
            return wrap(_det_sr(y, seed))

        if moments:
            def super_resolve_moments(self, wins, samples, normalize=False, seed=None):
                return tuple(map(wrap, _det_moments(wins, samples, seed)))

    return StandIn()


@pytest.fixture(params=[True, False], ids=["moments_hook", "draw_packing"])
def stand_ins(request, monkeypatch):
    """Both commands' local resolvers replaced by the same stand-in."""
    port = _stand_in(tiling.TileEndpoints, True, request.param)
    ref = _stand_in(jtiling.TileEndpoints, False, request.param)
    monkeypatch.setattr(raster, "_local_resolver", lambda args: port)
    monkeypatch.setattr(jserve.SuperResolver, "from_checkpoint",
                        classmethod(lambda cls, *a, **k: ref))
    return port, ref


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def _both(tmp_path, src, argv, name="sr", std=False):
    """Run the port's and JAX's command on ``src``; their outputs' bytes
    must be equal. Returns the port's output path."""
    paths = {}
    for label, mod in (("port", raster), ("jax", jraster)):
        out = str(tmp_path / f"{name}_{label}.tif")
        mod.main([src, out, "--model_ckpt", str(tmp_path / "ck"), *argv])
        paths[label] = out
    assert _bytes(paths["port"]) == _bytes(paths["jax"])
    if std:
        assert _bytes(paths["port"][:-4] + "_std.tif") == _bytes(paths["jax"][:-4] + "_std.tif")
    return paths["port"]


def _scene(tmp_path, shape=(40, 30, 4), seed=0, dtype=np.uint16, **write_kw):
    rng = np.random.default_rng(seed)
    lr = (rng.random(shape) * 2500 + 100).astype(dtype)
    src = str(tmp_path / f"lr_{seed}.tif")
    write_tiff(src, lr, **write_kw)
    return src, lr


@pytest.mark.parametrize("argv", [
    [],
    ["--stream"],
    ["--batch", "5", "--overlap", "2", "--request_seed", "4"],
    ["--stream", "--batch", "3", "--request_seed", "4", "--compression", "none"],
    ["--samples", "3", "--request_seed", "6"],
    ["--uncertainty", "--samples", "3", "--request_seed", "7"],
    ["--stream", "--uncertainty", "--samples", "2", "--batch", "4", "--request_seed", "8"],
    ["--stream", "--no_predictor", "--compression", "lzw"],
], ids=["memory", "stream", "seeded", "stream_seeded", "samples", "uncertainty",
        "stream_uncertainty", "stream_lzw"])
def test_products_are_byte_equal_to_jax(stand_ins, tmp_path, argv):
    src, _ = _scene(tmp_path, compression="deflate", predictor=True)
    out = _both(tmp_path, src, argv, std="--uncertainty" in argv)
    got = read_tiff(out)
    assert got.shape == (80, 60, 4) and got.dtype == np.uint16


@pytest.mark.parametrize("stream", [False, True], ids=["memory", "stream"])
def test_unit_scale_planar_and_nodata_are_byte_equal_to_jax(stand_ins, tmp_path, stream):
    extra = ["--stream"] if stream else []
    rng = np.random.default_rng(1)
    flt = rng.random((21, 18, 4)).astype(np.float32)
    src = str(tmp_path / "flt.tif")
    write_tiff(src, flt)
    out = _both(tmp_path, src, ["--scale", "unit", *extra], name="unit")
    assert read_tiff(out).dtype == np.float32
    planar = (rng.random((4, 20, 17)) * 900).astype(np.int16)
    src = str(tmp_path / "planar.tif")
    write_tiff(src, planar, planar_channels_first=True)
    out = _both(tmp_path, src, extra, name="planar")
    assert read_tiff(out).shape == (4, 40, 34)
    flt[3, 4, 1] = np.nan
    flt[10:12, :, 2] = np.nan
    src = str(tmp_path / "nodata.tif")
    write_tiff(src, flt)
    out = _both(tmp_path, src, ["--uncertainty", "--samples", "2", *extra], name="nodata",
                std=True)
    assert np.isfinite(read_tiff(out)).all()


def _crash_after(monkeypatch, n):
    """Make every TiffStripWriter (both packages') fail after ``n`` bands."""
    calls = {"n": 0}
    for mod in (tiffio, jtiffio):
        real = mod.TiffStripWriter.write_rows

        def bomb(self, block, real=real):
            calls["n"] += 1
            if calls["n"] > n:
                raise RuntimeError("simulated crash")
            return real(self, block)

        monkeypatch.setattr(mod.TiffStripWriter, "write_rows", bomb)
    return calls


def test_stream_resume_is_byte_equal_to_jax_and_to_an_uninterrupted_run(stand_ins, tmp_path,
                                                                         monkeypatch):
    src, _ = _scene(tmp_path, shape=(44, 30, 4), seed=2)
    flags = ["--stream", "--uncertainty", "--samples", "3", "--batch", "4",
             "--request_seed", "11"]
    full = _both(tmp_path, src, flags, name="full", std=True)
    ck = str(tmp_path / "ck")
    for label, mod in (("port", raster), ("jax", jraster)):
        part = str(tmp_path / f"part_{label}.tif")
        with monkeypatch.context() as m:
            _crash_after(m, 5)  # sr + std writes: the crash lands mid-sweep
            with pytest.raises(RuntimeError, match="simulated crash"):
                mod.main([src, part, "--model_ckpt", ck, *flags, "--resume"])
        assert os.path.exists(part + ".resume.json")
        with pytest.raises(ValueError, match="never finalized"):
            read_tiff(part)
        mod.main([src, part, "--model_ckpt", ck, *flags, "--resume"])
        assert not os.path.exists(part + ".resume.json")
        assert _bytes(part) == _bytes(full)
        assert _bytes(part[:-4] + "_std.tif") == _bytes(full[:-4] + "_std.tif")


def test_guards_refuse_as_jax(stand_ins, tmp_path, monkeypatch):
    three, _ = _scene(tmp_path, shape=(20, 20, 3), seed=3)
    src, _ = _scene(tmp_path, shape=(24, 20, 4), seed=4)
    ck = ["--model_ckpt", str(tmp_path / "ck")]
    for mod in (raster, jraster):
        dst = str(tmp_path / f"{mod.__name__}.tif")
        for extra in ([], ["--stream"]):
            with pytest.raises(SystemExit, match="3 band"):
                mod.main([three, dst, *ck, *extra])
        with pytest.raises(SystemExit):  # --resume needs --stream
            mod.main([src, dst, *ck, "--resume"])
        with pytest.raises(SystemExit, match="request_seed"):
            mod.main([src, dst, *ck, "--stream", "--resume"])
        with pytest.raises(SystemExit):
            mod.main([src, dst, *ck, "--request_seed", "-2"])
        with pytest.raises(SystemExit):  # a --url body encoding
            mod.main([src, dst, *ck, "--wire", "u16"])
        with pytest.raises(SystemExit):
            mod.main([src, dst, *ck, "--stall_timeout", "5"])
        with pytest.raises(SystemExit, match="model_ckpt or --url"):
            mod.main([src, dst])
        flags = [*ck, "--stream", "--request_seed", "5"]
        with monkeypatch.context() as m:
            _crash_after(m, 1)
            with pytest.raises(RuntimeError):
                mod.main([src, dst, *flags, "--resume"])
        with pytest.raises(SystemExit, match="different invocation"):
            mod.main([src, dst, *flags, "--resume", "--request_seed", "6"])
        with pytest.raises(SystemExit, match="different invocation"):
            mod.main([src, dst, *flags, "--resume", "--int8"])
    with pytest.raises(ValueError, match="backend"):
        raster.main([src, str(tmp_path / "x.tif"), *ck, "--backend", "tpu"])


def test_stall_watchdog_exits_3_and_the_journal_resumes(stand_ins, tmp_path):
    """A dispatch that never returns: ``--stall_timeout`` hard-exits with 3
    (in a subprocess: the abort is ``os._exit``) and ``--resume`` finishes
    the product of an uninterrupted run."""
    src, _ = _scene(tmp_path, shape=(40, 24, 4), seed=5)
    flags = ["--stream", "--batch", "4", "--request_seed", "3"]
    full = str(tmp_path / "full.tif")
    raster.main([src, full, "--model_ckpt", "ck", *flags])
    part = str(tmp_path / "part.tif")
    wedge = tmp_path / "wedge.py"
    wedge.write_text(f"""
import time
import numpy as np
from simple_vae_rs_tpu_torch import raster, tiling

class Wedged(tiling.TileEndpoints):
    window, normalize, calls = {WIN}, True, 0

    class model:
        class config:
            channels = 4

    def super_resolve(self, y, normalize=None, seed=None):
        Wedged.calls += 1
        if Wedged.calls > 4:
            time.sleep(600)  # a hung dispatch
        y = np.asarray(y, np.float32)
        up = np.repeat(np.repeat(y, 2, axis=1), 2, axis=2)
        return up + 0.1 * y.mean(axis=(1, 2, 3), keepdims=True) + np.float32((seed % 997) / 1e4)

raster._local_resolver = lambda args: Wedged()
raster.main([{src!r}, {part!r}, "--model_ckpt", "ck", *{flags!r}, "--resume",
             "--stall_timeout", "1"])
""")
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, str(wedge)], capture_output=True, text=True,
                          timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert "stalled" in proc.stderr and os.path.exists(part + ".resume.json")
    raster.main([src, part, "--model_ckpt", "ck", *flags, "--resume"])
    assert _bytes(part) == _bytes(full)


def test_real_tiny_model_from_a_port_checkpoint(tmp_path, monkeypatch):
    from simple_vae_rs_tpu_torch import Trainer
    from simple_vae_rs_tpu_torch.serve import SuperResolver
    from simple_vae_rs_tpu_torch.train.checkpoint import save_checkpoint

    _, _, tmodel = tiny_pair()
    tr = Trainer(tmodel, device="cpu")
    ck = str(tmp_path / "tiny")
    save_checkpoint(ck, tr, epoch=1, extra={"model": tr._model_meta()})
    src, lr = _scene(tmp_path, shape=(20, 27, 4), seed=9, dtype=np.int16, compression="lzw",
                     predictor=True)
    dst = str(tmp_path / "sr.tif")
    flags = ["--model_ckpt", ck, "--backend", "cpu", "--request_seed", "3", "--batch", "8"]
    raster.main([src, dst, *flags])
    out = read_tiff(dst)
    assert out.shape == (40, 54, 4) and out.dtype == np.int16
    sr = SuperResolver.from_checkpoint(ck, device="cpu")
    lrf = lr.astype(np.float32)
    mn = lrf.min(axis=(0, 1), keepdims=True)
    den = lrf.max(axis=(0, 1), keepdims=True) - mn + 1e-5
    want = sr.super_resolve_tile(lrf, batch=8, seed=3) * den + mn
    assert np.abs(out.astype(np.float32) - want).max() <= 0.5 + 1e-3 * np.abs(want).max()
    # streamed: window row k draws under subseed(seed, k), so the product
    # differs from the in-memory one's draws, but repeats to the byte
    streamed = [str(tmp_path / f"sr_stream{i}.tif") for i in range(2)]
    for path in streamed:
        raster.main([src, path, *flags, "--stream"])
    assert _bytes(streamed[0]) == _bytes(streamed[1])
    assert read_tiff(streamed[0]).shape == (40, 54, 4)
    # the card is the default: without one the command raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        raster.main([src, dst, "--model_ckpt", ck])
