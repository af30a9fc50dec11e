"""The port's serving stack (``wire``, ``batching``, ``server``, ``client``)
against the JAX package's.

- The u16 codec's arrays and ``.npz`` bytes equal JAX's.
- ``MicroBatcher`` is driven by threads joined on their results and by row
  caps, never a wall-clock bound: collection ends at ``max_batch`` rows.
- The JAX ``Client`` drives the port's server, and the port's ``Client``
  the JAX server, on every endpoint and body encoding (npy, npz, u16 wire,
  JSON, ``seed``) and on the 400 / 401 / 404 / 413 paths. Both servers
  serve the tiny Cond_SRVAE on the same weights; the port's draws a seeded
  request's noise from JAX's keys (``JaxNoiseResolver``), so the replies of
  the two servers match at rtol 1e-4 / atol 2e-5, and the reply keys and
  ``/healthz`` keys are equal.
"""

import io
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from simple_vae_rs_tpu import batching as jbatching
from simple_vae_rs_tpu import client as jclient
from simple_vae_rs_tpu import raster as jraster
from simple_vae_rs_tpu import server as jserver
from simple_vae_rs_tpu import wire as jwire
from simple_vae_rs_tpu.serve import SuperResolver as JSuperResolver

from simple_vae_rs_tpu_torch import batching, client, raster, server, wire
from simple_vae_rs_tpu_torch.data.tiffio import write_tiff
from tests.test_torch_port_tiling import WIN, JaxNoiseResolver, tiny_pair
from tests.test_torch_port_tiling import one_torch_thread  # noqa: F401 (autouse)

RTOL, ATOL = 1e-4, 2e-5
U16_TOL = 1.0 / 65535  # a whole quantization step of a [0, 1] channel
ROOT = __file__.rsplit("/tests/", 1)[0]


# ------------------------------------------------------------------- wire
def _wire_cases():
    rng = np.random.default_rng(0)
    x = rng.random((3, 7, 5, 4)).astype(np.float32) * np.float32([1, 100, 1e-3, 10])
    flat = np.full((4, 4, 2), 3.25, np.float32)
    tiny = np.stack([np.zeros(6, np.float32), np.float32(1e-36) * np.arange(6)], -1)
    neg = (rng.standard_normal((2, 16, 16, 4)) * 50).astype(np.float32)
    return {"scaled": x, "flat": flat, "sub_tiny_span": tiny, "signed": neg}


@pytest.mark.parametrize("case", sorted(_wire_cases()))
def test_wire_codec_bytes_equal_jax(case):
    x = _wire_cases()[case]
    got, want = wire.quantize_u16(x), jwire.quantize_u16(x)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    back = wire.dequantize_u16(*got)
    assert back.dtype == np.float32 and np.array_equal(back, jwire.dequantize_u16(*want))
    bodies = []
    for mod in (wire, jwire):
        buf = io.BytesIO()
        np.savez(buf, **mod.encode_arrays_u16({"sr": x, "std": x * 0.5}))
        bodies.append(buf.getvalue())
    assert bodies[0] == bodies[1]
    with np.load(io.BytesIO(bodies[0])) as z:
        entries = {k: z[k] for k in z.files}
    dec = wire.decode_arrays({**entries, "plain": x})
    assert set(dec) == {"sr", "std", "plain"} and np.array_equal(dec["plain"], x)
    for k, v in jwire.decode_arrays(entries).items():
        assert np.array_equal(dec[k], v)


def test_wire_refuses_as_jax():
    assert wire.WIRE_VALUES == jwire.WIRE_VALUES and wire.U16_MAX == jwire.U16_MAX
    for bad in (np.array([[1.0, np.nan]]), np.zeros((0, 3))):
        for mod in (wire, jwire):
            with pytest.raises(ValueError):
                mod.quantize_u16(bad)
    for mod in (wire, jwire):
        with pytest.raises(ValueError, match="reserved"):
            mod.encode_arrays_u16({"sr__lo": np.zeros(2)})


# --------------------------------------------------------------- batching
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 9, 16, 17, 63, 64, 65])
def test_bucket_size_equals_jax(n):
    assert batching.bucket_size(n) == jbatching.bucket_size(n)


def _submit_all(b, items):
    """Submit ``items`` ((lr, normalize) pairs) from one thread each; their
    results (or exceptions) in order."""
    out = [None] * len(items)

    def run(i, lr, norm):
        try:
            out[i] = b.submit(lr, norm)
        except BaseException as e:  # noqa: BLE001 - handed to the test
            out[i] = e

    threads = [threading.Thread(target=run, args=(i, *it)) for i, it in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    return out


@pytest.mark.parametrize("mod", [batching, jbatching], ids=["port", "jax"])
def test_batcher_coalesces_to_the_row_cap_and_returns_each_slice(mod):
    calls = []

    def fn(lr, normalize):
        calls.append((lr.shape[0], normalize))
        return torch.from_numpy(lr * 2) if mod is batching else lr * 2  # a tensor for the port

    # collection ends at max_batch rows: the 60 s windows never expire here
    b = mod.MicroBatcher(fn, max_batch=3, max_delay_ms=60_000, follow_ms=60_000)
    try:
        lrs = [np.full((1, 4, 4, 2), i, np.float32) for i in range(3)]
        got = _submit_all(b, [(lr, None) for lr in lrs])
        assert calls == [(4, None)]  # 3 rows padded to the bucket of 4
        for lr, out in zip(lrs, got):
            assert isinstance(out, np.ndarray) and np.array_equal(out, lr * 2)
        assert (b.requests, b.rows, b.dispatches, b.padded_rows) == (3, 3, 1, 1)
        text = b.render_metrics()
        assert "svrs_batcher_dispatches_total 1" in text and "padded_rows_total 1" in text
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(lrs[0])


def test_batcher_under_contention_returns_every_callers_rows():
    """More submitting threads than cores, a short switch interval: every
    caller gets its own rows back and the counters add up."""
    b = batching.MicroBatcher(lambda lr, norm: torch.from_numpy(lr + 0.5), max_batch=8,
                              max_delay_ms=1.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        items = [(np.full((1 + i % 3, 2, 2, 1), i, np.float32), None) for i in range(48)]
        got = _submit_all(b, items)
    finally:
        sys.setswitchinterval(interval)
        b.close()
    for (lr, _), out in zip(items, got):
        assert isinstance(out, np.ndarray) and np.array_equal(out, lr + 0.5)
    assert b.requests == 48 and b.rows == sum(lr.shape[0] for lr, _ in items)
    assert 1 <= b.dispatches <= 48


def test_batcher_groups_by_normalize_and_shape_and_forwards_errors():
    seen = []

    def fn(lr, normalize):
        seen.append((lr.shape, normalize))
        if normalize is False:
            raise ValueError("bad group")
        return torch.from_numpy(lr + 1)

    b = batching.MicroBatcher(fn, max_batch=5, max_delay_ms=60_000, follow_ms=60_000)
    try:
        items = [(np.zeros((2, 4, 4, 2), np.float32), True),
                 (np.ones((1, 4, 4, 2), np.float32), False),
                 (np.ones((1, 8, 8, 2), np.float32), True),
                 (np.full((1, 4, 4, 2), 3, np.float32), True)]
        got = _submit_all(b, items)
        assert sorted(seen, key=str) == sorted([((4, 4, 4, 2), True), ((1, 4, 4, 2), False),
                                                ((1, 8, 8, 2), True)], key=str)
        assert isinstance(got[1], ValueError)
        for i in (0, 2, 3):
            assert np.array_equal(got[i], items[i][0] + 1)
        assert b.dispatches == 2 and b.requests == 4
        with pytest.raises(ValueError, match="LR batch"):
            b.submit(np.zeros((4, 4), np.float32))
    finally:
        b.close()


# ------------------------------------------------------------ two servers
def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def urls():
    """The port's server and the JAX server on the same tiny weights, and
    variants of each (a bearer token, a 1 MiB body limit)."""
    jmodel, variables, tmodel = tiny_pair()
    port_res = JaxNoiseResolver(tmodel, device="cpu", seed=4)
    jax_res = JSuperResolver(jmodel, variables, seed=4)
    servers = {
        "port": server.make_server(port_res, port=0),
        "jax": jserver.make_server(jax_res, port=0),
        "port_token": server.make_server(port_res, port=0, token="s3cret"),
        "jax_token": jserver.make_server(jax_res, port=0, token="s3cret"),
        "port_small": server.make_server(port_res, port=0, max_body_mb=1),
        "jax_small": jserver.make_server(jax_res, port=0, max_body_mb=1),
    }
    yield {k: _serve(v) for k, v in servers.items()}
    for srv in servers.values():
        srv.shutdown()
        srv.server_close()


def _lr(b, seed):
    return np.random.default_rng(seed).random((b, WIN, WIN, 4)).astype(np.float32)


def _close(got, want, tol=(RTOL, ATOL)):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == np.float32 and g.shape == w.shape, k
        if k == "std":  # sqrt of a cancelling difference: held through the variance
            continue
        np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1], err_msg=k)


def _requests(c):
    """Every endpoint, seeded, through client ``c``: name -> reply dict."""
    raster_ = np.random.default_rng(3).random((12, 17, 4)).astype(np.float32) * 900
    s1, s2 = c.super_resolve_moments(_lr(2, 2), 3, seed=7)
    return {
        "super_resolve": {"sr": c.super_resolve(_lr(2, 1), seed=5)},
        "super_resolve_unnormalized": {"sr": c.super_resolve(_lr(2, 1), normalize=False,
                                                             seed=6)},
        "moments": {"s1": s1, "s2": s2},
        "tile": {"sr": c.super_resolve_tile(raster_, overlap=2, batch=4, seed=8)},
        "tile_samples": {"sr": c.super_resolve_tile(raster_, batch=4, samples=2, seed=9)},
        "uncertainty_tile": c.uncertainty_tile(raster_, samples=3, overlap=2, batch=4, seed=10),
    }


@pytest.mark.parametrize("wire_opt", ["f32", "u16"])
def test_each_client_drives_the_other_packages_server(urls, wire_opt):
    tol = (RTOL, ATOL) if wire_opt == "f32" else (RTOL, ATOL + 2 * U16_TOL)
    for cmod, smod in ((jclient, "port"), (client, "jax")):
        c = cmod.Client(urls[smod], timeout=30, wire=wire_opt)
        ref = client.Client(urls["jax"], timeout=30, wire=wire_opt)
        got, want = _requests(c), _requests(ref)
        for name in want:
            if name in ("moments", "tile_samples") and wire_opt == "u16":
                continue  # sums of draws: the u16 step scales with their range
            _close(got[name], want[name], tol)
        assert np.array_equal(got["uncertainty_tile"]["std"],
                              np.sqrt(got["uncertainty_tile"]["variance"])) or wire_opt == "u16"
        # uncertainty draws from each package's own generator: keys and shapes
        u, v = c.uncertainty(_lr(1, 4)[0], samples=3, chunk=3, seed=2), \
            ref.uncertainty(_lr(1, 4)[0], samples=3, chunk=3, seed=2)
        assert set(u) == set(v) == {"mean", "std", "variance"}
        assert all(u[k].shape == v[k].shape == (2 * WIN, 2 * WIN, 4) for k in u)


def test_seeded_replies_repeat_and_unseeded_ones_do_not(urls):
    for cmod in (client, jclient):
        c = cmod.Client(urls["port"], timeout=30)
        a = c.super_resolve(_lr(2, 1), seed=5)
        assert np.array_equal(a, c.super_resolve(_lr(2, 1), seed=5))
        assert not np.array_equal(a, c.super_resolve(_lr(2, 1), seed=6))
        assert not np.array_equal(c.super_resolve(_lr(2, 1)), c.super_resolve(_lr(2, 1)))
        u = cmod.Client(urls["port"], timeout=30, wire="u16")
        assert np.array_equal(u.super_resolve(_lr(2, 1), seed=5),
                              u.super_resolve(_lr(2, 1), seed=5))
        assert np.abs(u.super_resolve(_lr(2, 1), seed=5) - a).max() <= U16_TOL


def test_healthz_and_reply_keys_equal_jax(urls):
    hp, hj = client.Client(urls["port"]).health(), jclient.Client(urls["jax"]).health()
    assert set(hp) == set(hj)
    for k in ("status", "model", "patch_size", "channels", "int8", "int8_weights", "mesh",
              "moments", "seed", "wire_u16"):
        assert hp[k] == hj[k], k
    lr = _lr(2, 3)  # the shapes and options of _requests: no new JAX compile
    for path, extra in (("/v1/super_resolve", {}), ("/v1/super_resolve_moments", {"samples": 3}),
                        ("/v1/super_resolve_tile", {"batch": 4}),
                        ("/v1/uncertainty", {"samples": 3, "chunk": 3}),
                        ("/v1/uncertainty_tile", {"samples": 3, "batch": 4})):
        arr = lr[0] if "tile" in path or "uncertainty" in path else lr
        replies = []
        for name in ("port", "jax"):
            body = json.dumps({"lr": arr.tolist(), "seed": 1, **extra}).encode()
            raw, ctype = _post(urls[name] + path, body, "application/json")
            assert ctype == "application/json"
            replies.append(json.loads(raw))
        assert set(replies[0]) == set(replies[1]), path
        for k in replies[0]:
            assert np.shape(replies[0][k]) == np.shape(replies[1][k])
    # the metrics page counts the requests above
    text = urllib.request.urlopen(urls["port"] + "/metrics", timeout=30).read().decode()
    assert 'svrs_requests_total{endpoint="/v1/super_resolve",outcome="ok"}' in text


def _post(url, body, ctype, token=None):
    headers = {"Content-Type": ctype}
    if token:
        headers["Authorization"] = f"Bearer {token}"
    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.read(), resp.headers.get("Content-Type")


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_error_paths_match_jax(urls):
    lr = _lr(1, 5)
    for name in ("port", "jax"):
        base = urls[name]
        cases = [
            (base + "/v1/nope", b"{}", "application/json", 404),
            (base + "/v1/super_resolve?seed=-1", client.Client._npy(lr), "application/x-npy", 400),
            (base + "/v1/super_resolve?wire=u8", client.Client._npy(lr), "application/x-npy", 400),
            (base + "/v1/super_resolve", _npz(lr=lr.astype(np.uint16)), "application/x-npz", 400),
            (base + "/v1/super_resolve", _npz(other=lr), "application/x-npz", 400),
            (base + "/v1/super_resolve", b"{}", "application/json", 400),
            (base + "/v1/super_resolve", b"\x00not a zip", "application/x-npz", 400),
        ]
        for url, body, ctype, code in cases:
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url, body, ctype)
            assert e.value.code == code, (name, url)
            assert "error" in json.loads(e.value.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nope", timeout=30)
        assert e.value.code == 404
        # a plain float32 npz body is served like npy
        raw, ctype = _post(base + "/v1/super_resolve?seed=3", _npz(lr=lr), "application/x-npz")
        assert np.load(io.BytesIO(raw)).shape == (1, 2 * WIN, 2 * WIN, 4)
    for cmod, name in ((jclient, "port"), (client, "jax")):
        with pytest.raises(cmod.ServerError, match="401"):
            cmod.Client(urls[name + "_token"], timeout=30).super_resolve(lr)
        ok = cmod.Client(urls[name + "_token"], timeout=30, token="s3cret").super_resolve(lr)
        assert ok.shape == (1, 2 * WIN, 2 * WIN, 4)
        assert cmod.Client(urls[name + "_token"]).health()["status"] == "ok"  # healthz is open
        big = np.zeros((1, 300, 300, 4), np.float32)  # 1.4 MiB > the 1 MiB limit
        with pytest.raises(cmod.ServerError, match="413"):
            cmod.Client(urls[name + "_small"], timeout=30, retries=0).super_resolve_tile(big)


def test_remote_resolvers_stitch_what_the_servers_stitch(urls):
    raster_ = np.random.default_rng(11).random((13, 18, 4)).astype(np.float32) * 700
    for cmod, name in ((jclient, "port"), (client, "jax"), (client, "port")):
        c = cmod.Client(urls[name], timeout=30)
        rr = c.resolver()
        try:
            assert rr.window == WIN and rr.channels == 4
            remote = rr.super_resolve_tile(raster_, batch=4, seed=12)
            assert np.array_equal(remote, c.super_resolve_tile(raster_, batch=4, seed=12))
            maps = rr.uncertainty_tile(raster_, samples=2, batch=4, seed=13)
            want = c.uncertainty_tile(raster_, samples=2, batch=4, seed=13)
            for k in want:
                assert np.array_equal(maps[k], want[k]), k
        finally:
            rr.close()


def test_raster_url_is_byte_equal_to_jax_and_to_local_windows(urls, tmp_path):
    lr = (np.random.default_rng(12).random((21, 26, 4)) * 3000 + 100).astype(np.uint16)
    src = str(tmp_path / "lr.tif")
    write_tiff(src, lr)
    flags = ["--batch", "4", "--request_seed", "14", "--timeout", "30"]
    for extra in ([], ["--stream"], ["--stream", "--uncertainty", "--samples", "2"],
                  ["--wire", "u16"]):
        outs = []
        for label, mod in (("port", raster), ("jax", jraster)):
            out = str(tmp_path / f"{label}{len(extra)}.tif")
            mod.main([src, out, "--url", urls["jax"], *flags, *extra])
            outs.append(open(out, "rb").read())
        assert outs[0] == outs[1], extra
    # and against the port's server
    out = str(tmp_path / "port_server.tif")
    raster.main([src, out, "--url", urls["port"], *flags, "--stream"])


def test_dynamic_batching_and_the_device_prober_on_the_port_server():
    _, _, tmodel = tiny_pair()
    res = JaxNoiseResolver(tmodel, device="cpu", seed=1)
    srv = server.make_server(res, port=0, dynamic_batch_ms=5, probe_device_s=30)
    url = _serve(srv)
    try:
        c = client.Client(url, timeout=30)
        outs = [None] * 6

        def post(i):
            outs[i] = c.super_resolve(_lr(1, 20 + i))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert all(o is not None and o.shape == (1, 2 * WIN, 2 * WIN, 4) for o in outs)
        service = srv.RequestHandlerClass.service
        assert 1 <= service.batcher.dispatches <= 6 and service.batcher.requests == 6
        seeded = c.super_resolve(_lr(1, 30), seed=3)  # seeded: a private dispatch
        assert np.array_equal(seeded, c.super_resolve(_lr(1, 30), seed=3))
        health = c.health()
        assert health["device"]["ok"] and health["status"] == "ok"
        service.prober._dispatch()  # one round trip on the resolver's device
        service.prober.stale_after = 0.0  # a heartbeat that went stale
        degraded = c.health()
        assert degraded["status"] == "degraded" and not degraded["device"]["ok"]
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(url + "/healthz", timeout=30)
        assert e.value.code == 503
        assert "svrs_device_probe_ok 0" in urllib.request.urlopen(
            url + "/metrics", timeout=30).read().decode()
    finally:
        srv.shutdown()
        srv.server_close()


def test_server_main_raises_on_what_is_not_ported_and_without_a_card(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError, match="meta.json"):
        server.main(["--artifact", str(tmp_path / "a.pt2"), "--backend", "cpu"])
    for argv, match in ((["--model_ckpt", "ck", "--mesh_data", "2"], "A.8"),
                        (["--model_ckpt", "ck", "--pallas_conv"], "pallas_conv"),
                        (["--model_ckpt", "ck", "--backend", "tpu"], "backend")):
        with pytest.raises(ValueError, match=match):
            server.main(argv)
    from simple_vae_rs_tpu_torch import Trainer
    from simple_vae_rs_tpu_torch.train.checkpoint import save_checkpoint

    _, _, tmodel = tiny_pair()
    tr = Trainer(tmodel, device="cpu")
    ck = str(tmp_path / "tiny")
    save_checkpoint(ck, tr, epoch=1, extra={"model": tr._model_meta()})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        server.main(["--model_ckpt", ck])


def test_client_imports_without_torch():
    code = ("import sys\n"
            "import simple_vae_rs_tpu_torch.client, simple_vae_rs_tpu_torch.raster\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax')]\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
