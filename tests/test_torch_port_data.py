"""The port's data path against the JAX package's, on the CPU: the TIFF codec,
the datasets, the on-device crops and the loader (order, batches, threads).

Tolerances: files, codecs and dataset items bit for bit (the same integer
and float arithmetic in numpy); the crops and the normalized batches within
1e-6 absolute (values in [0, 1]; float32 min-max in another library).
"""

import importlib.util
import os
import pathlib
import threading
import time

import jax
import numpy as np
import pytest
import torch

from simple_vae_rs_tpu.data import datasets as jds
from simple_vae_rs_tpu.data import loader as jloader
from simple_vae_rs_tpu.data import tiffio as jtiff
from simple_vae_rs_tpu.ops import patchify as jpatch

from simple_vae_rs_tpu_torch.data import datasets as tds
from simple_vae_rs_tpu_torch.data import loader as tloader
from simple_vae_rs_tpu_torch.data import lzw_native
from simple_vae_rs_tpu_torch.data import tiffio as ttiff
from simple_vae_rs_tpu_torch.ops import patchify as tpatch

ROOT = pathlib.Path(__file__).resolve().parent


def _np(x):
    return np.array(jax.device_get(x))


# -------------------------------------------------------------------- TIFF
def _image(dtype, layout, seed=3):
    rng = np.random.default_rng(seed)
    shape = {"hwc": (19, 13, 4), "chw": (4, 19, 13), "hw": (19, 13)}[layout]
    hi = 200 if np.dtype(dtype) == np.uint8 else 30000
    arr = rng.random(shape) * hi
    if np.dtype(dtype).kind == "i":
        arr -= hi / 2
    return arr.astype(dtype)


CASES = [(dt, comp, pred, layout)
         for dt in (np.uint8, np.uint16, np.int16, np.float32)
         for comp in ("none", "deflate", "lzw")
         for pred in (False, True) if not (pred and np.dtype(dt).kind == "f")
         for layout in ("hwc", "chw", "hw")]


@pytest.mark.parametrize("dtype, compression, predictor, layout", CASES)
def test_tiff_files_cross_read_with_jax(tmp_path, dtype, compression, predictor, layout):
    """A file the port writes reads back in JAX as written, and a file JAX
    writes reads back in the port, both bit for bit; the two writers give the
    same bytes."""
    arr = _image(dtype, layout)
    kw = dict(planar_channels_first=layout == "chw", compression=compression,
              predictor=predictor)
    ours, theirs = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    ttiff.write_tiff(ours, arr, **kw)
    jtiff.write_tiff(theirs, arr, **kw)
    got_j, got_t = jtiff.read_tiff(ours), ttiff.read_tiff(theirs)
    assert got_j.dtype == got_t.dtype == arr.dtype
    np.testing.assert_array_equal(got_j, arr)
    np.testing.assert_array_equal(got_t, arr)
    assert pathlib.Path(ours).read_bytes() == pathlib.Path(theirs).read_bytes()
    with ttiff.TiffReader(theirs) as r:
        assert r.layout == layout
        np.testing.assert_array_equal(r.to_hwc(r.read_rows(5, 17)),
                                      jtiff.layout_to_hwc(layout)(arr[:, 5:17] if layout == "chw"
                                                                  else arr[5:17]))


def _test_data_module():
    spec = importlib.util.spec_from_file_location("jax_test_data", ROOT / "test_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("compression, predictor", [(1, False), (8, True), (5, False),
                                                    (5, True)])
def test_tiff_reads_the_legacy_monolithic_planar_strip(tmp_path, compression, predictor):
    """Band-sequential data in one strip (the JAX tests' writer of that
    layout): the whole image and row windows, with one decode."""
    chw = (np.random.default_rng(13).random((4, 14, 9)) * 60000).astype(np.uint16)
    path = str(tmp_path / "legacy.tif")
    _test_data_module()._write_monolithic_planar(path, chw, compression, predictor)
    np.testing.assert_array_equal(ttiff.read_tiff(path), chw)
    ttiff.reset_codec_calls()
    with ttiff.TiffReader(path) as r:
        assert r.layout == "chw"
        np.testing.assert_array_equal(r.read_rows(3, 11), chw[:, 3:11])
        np.testing.assert_array_equal(r.read_rows(0, 14), chw)
    assert sum(ttiff.CODEC_CALLS.values()) == (1 if compression == 5 else 0)


def test_tiff_reads_big_endian_and_refuses_what_it_cannot(tmp_path):
    """A big-endian file (what JAX's reader also takes), an unfinished one,
    an unknown compression."""
    arr = _image(np.int16, "hwc")
    path = str(tmp_path / "le.tif")
    ttiff.write_tiff(path, arr)
    # rewrite as big-endian: the header, the IFD and the samples
    with ttiff.TiffReader(path) as r:
        offset, count = r._offsets[0], r._counts[0]
    raw = bytearray(pathlib.Path(path).read_bytes())
    import struct

    def swap_ifd(buf, off):
        n = struct.unpack_from("<H", buf, off)[0]
        struct.pack_into(">H", buf, off, n)
        for i in range(n):
            e = off + 2 + 12 * i
            tag, typ, cnt = struct.unpack_from("<HHI", buf, e)
            size = ttiff._TYPE_SIZES[typ] * cnt
            fmt = ttiff._TYPE_FMT[typ]
            if size <= 4:
                vals = struct.unpack_from("<" + fmt * cnt, buf, e + 8)
                struct.pack_into(">HHI", buf, e, tag, typ, cnt)
                struct.pack_into(">" + fmt * cnt, buf, e + 8, *vals)
            else:
                (ptr,) = struct.unpack_from("<I", buf, e + 8)
                vals = struct.unpack_from("<" + fmt * cnt, buf, ptr)
                struct.pack_into(">HHII", buf, e, tag, typ, cnt, ptr)
                struct.pack_into(">" + fmt * cnt, buf, ptr, *vals)

    (ifd,) = struct.unpack_from("<I", raw, 4)
    swap_ifd(raw, ifd)
    raw[0:8] = struct.pack(">2sHI", b"MM", 42, ifd)
    raw[offset:offset + count] = arr.astype(">i2").tobytes()
    big = tmp_path / "be.tif"
    big.write_bytes(bytes(raw))
    np.testing.assert_array_equal(ttiff.read_tiff(str(big)), arr)
    np.testing.assert_array_equal(jtiff.read_tiff(str(big)), arr)

    w = ttiff.TiffStripWriter(str(tmp_path / "open.tif"), 4, 4)
    w.write_rows(np.zeros((4, 4), np.uint8))
    w._fh.close()  # never finalized
    with pytest.raises(ValueError, match="never finalized"):
        ttiff.read_tiff(str(tmp_path / "open.tif"))
    with pytest.raises(ValueError, match="compression=7 unsupported"):
        ttiff._decompress_strip(b"", 7, "x.tif")


def test_lzw_codec_matches_jax_and_native_matches_python():
    """The port's encoder gives JAX's bytes (Python and native), native
    decoding equals Python decoding, across width growth, table resets and
    a truncated strip."""
    assert lzw_native.get_lib() is not None, lzw_native.build_error
    rng = np.random.default_rng(8)
    streams = [b"", b"a", b"TOBEORNOTTOBEORTOBEORNOT#" * 40,
               bytes(rng.integers(0, 256, 70000, dtype=np.uint8)),
               bytes(rng.integers(0, 4, 50000, dtype=np.uint8)),
               (np.arange(30000, dtype=np.uint8) % 7).tobytes()]
    for data in streams:
        enc = ttiff._lzw_encode(data)
        assert enc == jtiff._lzw_encode(data)
        assert lzw_native.lzw_encode_native(data) == enc
        assert ttiff._lzw_decode(enc) == data
        assert lzw_native.lzw_decode_native(enc, len(data)) == data
        assert lzw_native.lzw_decode_native(enc, 0) == data  # the buffer regrows
    cut = ttiff._lzw_encode(streams[3])[:5000]
    assert lzw_native.lzw_decode_native(cut) == ttiff._lzw_decode(cut) == jtiff._lzw_decode(cut)
    with pytest.raises(ValueError, match="corrupt LZW"):
        ttiff._lzw_decode(bytes([0x80, 0x7F, 0xFF, 0xFF]))
    assert lzw_native.lzw_decode_native(bytes([0x80, 0x7F, 0xFF, 0xFF])) is None
    assert lzw_native.lib_path().is_relative_to(ROOT.parent / "build")


def test_lzw_files_take_the_native_codec(tmp_path):
    arr = _image(np.int16, "hwc")
    ttiff.reset_codec_calls()
    ttiff.write_tiff(str(tmp_path / "a.tif"), arr, compression="lzw", predictor=True)
    ttiff.read_tiff(str(tmp_path / "a.tif"))
    assert ttiff.CODEC_CALLS == {"native_decode": 1, "python_decode": 0, "native_encode": 1,
                                 "python_encode": 0}


def test_strip_writer_checkpoint_resume_round_trip(tmp_path):
    """Interrupt a striped write mid-scene (torn rows past the checkpoint),
    resume from the checkpoint: the same bytes as one write, which JAX reads;
    a resume state of another geometry is refused."""
    img = (np.random.default_rng(0).random((37, 21, 3)) * 60000).astype(np.uint16)
    kw = dict(planar_channels_first=True, compression="lzw", predictor=True,
              rows_per_strip=8)
    one = str(tmp_path / "one.tif")
    with ttiff.TiffStripWriter(one, 37, 21, 3, np.uint16, **kw) as w:
        w.write_rows(np.moveaxis(img, -1, 0))
    two = str(tmp_path / "two.tif")
    w = ttiff.TiffStripWriter(two, 37, 21, 3, np.uint16, **kw)
    w.write_rows(np.moveaxis(img[:19], -1, 0))  # 2 full strips + 3 rows pending
    state = w.checkpoint()
    w.write_rows(np.moveaxis(img[19:30], -1, 0))  # torn: past the checkpoint
    w._fh.close()  # a crash: no close(), no IFD
    w = ttiff.TiffStripWriter(two, 37, 21, 3, np.uint16, resume_state=state, **kw)
    w.write_rows(np.moveaxis(img[19:], -1, 0))
    w.close()
    assert pathlib.Path(one).read_bytes() == pathlib.Path(two).read_bytes()
    np.testing.assert_array_equal(jtiff.read_tiff(two), np.moveaxis(img, -1, 0))
    with pytest.raises(ValueError, match="resume state"):
        ttiff.TiffStripWriter(str(tmp_path / "x.tif"), 50, 21, 3, np.uint16,
                              resume_state=state, **kw)


# ---------------------------------------------------------------- datasets
def _arm_tree(root, n, lr_px=16, seed=6, planar=True):
    """An ARM-shaped tree: int16 DN tiles, LZW with the predictor, and the
    tab-separated index.csv."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    rows = ["b2b3b4b8_10m\tb2b3b4b8_05m"]
    for i in range(n):
        lr = (rng.random((4, lr_px, lr_px)) * 10000).astype(np.int16)
        hr = (rng.random((4, 2 * lr_px, 2 * lr_px)) * 10000).astype(np.int16)
        if not planar:
            lr, hr = np.moveaxis(lr, 0, -1), np.moveaxis(hr, 0, -1)
        for name, arr in ((f"lr_{i}.tif", lr), (f"hr_{i}.tif", hr)):
            ttiff.write_tiff(os.path.join(root, name), arr, planar_channels_first=planar,
                             compression="lzw", predictor=True)
        rows.append(f"lr_{i}.tif\thr_{i}.tif")
    with open(os.path.join(root, "index.csv"), "w") as fh:
        fh.write("\n".join(rows))
    return root


def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        for x, y in zip(a[i], b[i]):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("planar", [True, False])
def test_sen2venus_dataset_equals_jax(tmp_path, planar):
    root = _arm_tree(str(tmp_path / "ARM"), 3, planar=planar)
    ours, theirs = tds.Sen2VenusDataset(root=root), jds.Sen2VenusDataset(root=root)
    _same_items(ours, theirs)
    assert ours[0][0].dtype == np.int16 and ours[0][1].shape == (32, 32, 4)


def test_flood_dataset_equals_jax(tmp_path):
    site = tmp_path / "site1" / "S2"
    os.makedirs(site)
    img = (np.random.default_rng(7).random((4, 128, 96)) * 5000).astype(np.uint16)
    ttiff.write_tiff(str(site / "a.tif"), img, planar_channels_first=True, compression="deflate")
    _same_items(tds.FloodDataset(str(tmp_path), 64), jds.FloodDataset(str(tmp_path), 64))


@pytest.mark.parametrize("name", ["SyntheticSRDataset", "SyntheticHFDataset"])
def test_synthetic_datasets_equal_jax(name):
    kw = dict(length=3, hr_size=64, seed=4)
    _same_items(getattr(tds, name)(**kw), getattr(jds, name)(**kw))


# ------------------------------------------------------------------- crops
def test_crops_equal_jax():
    """``grid_sr_batch`` and ``grid_single_batch`` on int16 tiles, and
    ``random_sr_crop_batch`` given the offsets JAX draws from its key."""
    rng = np.random.default_rng(2)
    lr = (rng.random((3, 32, 32, 4)) * 9000).astype(np.int16)
    hr = (rng.random((3, 64, 64, 4)) * 9000).astype(np.int16)
    for got, want in zip(tpatch.grid_sr_batch(torch.from_numpy(lr), torch.from_numpy(hr), 32),
                         jpatch.grid_sr_batch(lr, hr, 32)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tpatch.grid_single_batch(torch.from_numpy(hr), 16).numpy(),
                               _np(jpatch.grid_single_batch(hr, 16)), atol=1e-6, rtol=0)
    key = jax.random.PRNGKey(9)
    top = _np(jax.random.randint(jax.random.fold_in(key, 0), (3,), 0, 32 - 8))
    left = _np(jax.random.randint(jax.random.fold_in(key, 1), (3,), 0, 32 - 8))
    got = tpatch.random_sr_crop_batch(torch.from_numpy(lr), torch.from_numpy(hr), 16,
                                      offsets=(torch.from_numpy(top), torch.from_numpy(left)))
    want = jpatch.random_sr_crop_batch(key, lr, hr, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-6, rtol=0)
    # the port's own draws stay in range and pair the LR and HR crops
    a, b = tpatch.crop_offsets(1000, (32, 32), 16, torch.Generator().manual_seed(0))
    assert int(a.min()) == 0 and int(a.max()) == 23 and int(b.max()) == 23


# ------------------------------------------------------------------ loader
def _jax_offsets(self, step, b, lr_hw, generator):
    rng = jax.random.fold_in(jax.random.PRNGKey(self.seed + 7919 * self.epoch), step)
    p2 = self.patch_size // 2
    top = jax.random.randint(jax.random.fold_in(rng, 0), (b,), 0, lr_hw[0] - p2)
    left = jax.random.randint(jax.random.fold_in(rng, 1), (b,), 0, lr_hw[1] - p2)
    return torch.from_numpy(_np(top)), torch.from_numpy(_np(left))


@pytest.mark.parametrize("crop", ["grid", "random"])
def test_loader_batches_equal_jax(tmp_path, crop, monkeypatch):
    """From an int16 LZW tree on disk, three epochs of both splits (the first
    iter() taken for one batch, as the JAX CLI's ``init_state`` does): the
    same batches within 1e-6, the random crops given JAX's offsets."""
    root = _arm_tree(str(tmp_path / "ARM"), 10)
    monkeypatch.setattr(tloader.DeviceLoader, "crop_offsets", _jax_offsets)
    ours = tloader.init_dataloader("s2v", 2, 16, crop=crop, data_root=root, seed=3,
                                   device="cpu")
    theirs = jloader.init_dataloader("s2v", 2, 16, crop=crop, data_root=root, seed=3)
    next(iter(theirs[0]))
    ours[0].epoch += 1
    for _ in range(3):
        for mine, jl in zip(ours, theirs):
            got, want = list(mine), list(jl)
            assert len(got) == len(want) == len(jl)
            for g, w in zip(got, want):
                for gt, wt in zip(g, w):
                    assert gt.dtype == torch.float32
                    np.testing.assert_allclose(gt.numpy(), _np(wt), atol=1e-6, rtol=0)
    assert ours[0].epoch == theirs[0]._epoch == 4


class _Tagged:
    """Tile pairs whose content names their index: a single 1 at pixel i of
    channel 0 (which min-max normalization keeps), zero elsewhere."""

    def __init__(self, n, lr_px=8):
        self.n, self.lr_px = n, lr_px

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        lr = np.zeros((self.lr_px, self.lr_px, 4), np.float32)
        lr.reshape(-1, 4)[i, 0] = 1.0
        return lr, np.zeros((2 * self.lr_px, 2 * self.lr_px, 4), np.float32)


def _order(batches):
    return [int(i) for y, _ in batches
            for i in np.asarray(y)[..., 0].reshape(len(y), -1).argmax(axis=1)]


def test_loader_tile_order_per_epoch_equals_jax():
    """The tiles of each step of each epoch, the JAX CLI's way: one iter()
    for ``init_state``, one per pre-training epoch, then the fit's epochs."""
    ds = _Tagged(40)
    ours = tloader.DeviceLoader(ds, 4, 16, crop="grid", shuffle=True, seed=5, device="cpu")
    theirs = jloader.DeviceLoader(ds, 4, 16, crop="grid", shuffle=True, seed=5)
    next(iter(theirs))  # the JAX CLI's init_state batch
    ours.epoch += 1  # the port CLI's counterpart
    orders = []
    for _ in range(4):
        got, want = _order(ours), _order(theirs)
        assert got == want and sorted(got) == list(range(40))
        orders.append(got)
    assert len({tuple(o) for o in orders}) == 4  # each epoch shuffles anew
    assert orders[0] == [int(i) for i in np.random.default_rng(5 + 2).permutation(40)]


def test_loader_workers_give_the_same_batches(tmp_path):
    root = _arm_tree(str(tmp_path / "ARM"), 8)
    one = tloader.init_dataloader("s2v", 2, 16, crop="random", data_root=root, seed=1,
                                  device="cpu")[0]
    four = tloader.init_dataloader("s2v", 2, 16, crop="random", data_root=root, seed=1,
                                   device="cpu", workers=4)[0]
    for _ in range(2):
        for a, b in zip(one, four):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    four.close()
    four.close()  # idempotent
    assert four.workers == 1


def _loader_threads():
    return [t for t in threading.enumerate() if t.name == "svrs-loader" and t.is_alive()]


def test_loader_abandoned_iteration_stops_its_thread():
    ds = tds.SyntheticSRDataset(length=12, hr_size=64, seed=10)
    for _ in range(3):
        it = iter(tloader.DeviceLoader(ds, 2, 32, crop="grid", device="cpu"))
        next(it)
        del it  # the generator's finalizer sets the stop event
    deadline = time.time() + 5
    while _loader_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not _loader_threads()


def test_loader_errors_reach_the_consumer():
    class Broken(_Tagged):
        def __getitem__(self, i):
            if i == 5:
                raise OSError("bad tile 5")
            return super().__getitem__(i)

    with pytest.raises(OSError, match="bad tile 5"):
        list(tloader.DeviceLoader(Broken(8), 2, 16, crop="grid", device="cpu", workers=2))


def test_init_dataloader_split_and_refusals():
    train, val = tloader.init_dataloader("synthetic", 4, 64, device="cpu")
    assert (len(train.dataset), len(val.dataset)) == (51, 13)
    assert (train.shuffle, val.shuffle, train.seed, val.seed) == (True, False, 0, 1)
    with pytest.raises(ValueError, match="val split has 13 tiles — fewer than one batch of 16"):
        tloader.init_dataloader("synthetic", 16, 64, device="cpu")
    with pytest.raises(ValueError, match="Unknown dataset"):
        tloader.init_dataloader("nope", 1, 64, device="cpu")
    with pytest.raises(ValueError, match="Crop must be"):
        tloader.DeviceLoader(_Tagged(4), 2, 16, crop="center", device="cpu")
    if not torch.cuda.is_available():  # the card is the default, and not silently skipped
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tloader.init_dataloader("synthetic", 4, 64)
