"""The port's ``torch.export`` artifacts (``export.py``) against the JAX
package's StableHLO artifacts and the live resolver, on the CPU.

Every case of the JAX package's ``tests/test_export.py`` runs here on the
port, on the tiny Cond_SRVAE (``CondSRVAEConfig(cr=2.0, patch_size=16)``,
artifact batch 4; weights from ``tests/test_torch_port_tiling.tiny_pair``,
no JAX init compile). Beside them:

- the port's graph fed the noise a JAX artifact's key draws (``split`` of
  the key, then ``normal`` of ``generation_noise_shapes``) against the JAX
  artifact of the same weights, in each weight mode: atol 1e-4 (float32
  through ~25 convolutions summed in other orders; bf16 and int8 dequantize
  the same stored bits on both sides);
- the packing (``_rtn_numpy``, the bf16 cast): bit-equal to JAX's; the
  graph's dequantization bit-equal to numpy's, and a bf16 or int8 artifact
  within 1e-6 of the live resolver on the weights it stores;
- a seeded request off the artifact against the live ``SuperResolver``'s
  plain path on the same seed: atol 1e-6 (the same ops on the same inputs;
  only the export's decomposition may reorder a sum);
- the graph: ``aten`` ops only; and it loads and runs in a process that
  imports only torch.
"""

import copy
import json
import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from simple_vae_rs_tpu import export as jexport
from simple_vae_rs_tpu.serve import SuperResolver as JSuperResolver

from simple_vae_rs_tpu_torch import export as tex
from simple_vae_rs_tpu_torch import server
from simple_vae_rs_tpu_torch.serve import SuperResolver
from tests.test_torch_port_tiling import one_torch_thread, tiny_pair  # noqa: F401

PS, WIN, BATCH, C = 16, 8, 4, 4


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """The tiny model's live resolvers (JAX and port, the same weights) and
    the port's artifacts in the three weight modes."""
    jmodel, variables, tmodel = tiny_pair()
    resolver = SuperResolver(tmodel, device="cpu", seed=3)
    d = tmp_path_factory.mktemp("texp")
    paths = {w: tex.export_resolver(resolver, str(d / f"model_{w}.pt2"), batch=BATCH, weights=w)
             for w in tex.WEIGHT_MODES}
    loaded = {w: tex.load_exported(p, device="cpu") for w, p in paths.items()}
    return SimpleNamespace(jmodel=jmodel, variables=variables, tmodel=tmodel,
                           resolver=resolver, paths=paths, dir=d,
                           programs={w: esr._program for w, esr in loaded.items()})


def _load(art, weights="f32", seed=0):
    """A resolver on the loaded artifact (each file is loaded once, by the
    fixture, through ``load_exported``)."""
    meta = json.load(open(art.paths[weights] + ".meta.json"))
    return tex.ExportedResolver(art.programs[weights], meta, seed=seed, device="cpu")


def _y(seed, b, scale=1.0):
    return (np.random.default_rng(seed).random((b, WIN, WIN, C)) * scale).astype(np.float32)


def _inputs(esr, b, seed):
    """A full batch of inputs for ``_call``: y, noise, the flag."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.from_numpy(_y(seed, b, 700)), *esr._noise(b, (WIN, WIN), gen),
            torch.tensor(True))


# ------------------------------------------------------------ the artifact
def test_artifact_files_and_meta(art):
    meta = json.load(open(art.paths["f32"] + ".meta.json"))
    assert meta["format"] == "svrs-torch-export/1"
    assert meta["model_type"] == "CondSRVAE"
    assert (meta["patch_size"], meta["channels"], meta["batch"]) == (PS, C, BATCH)
    assert meta["normalize"] is True and meta["weights"] == "f32" and meta["scale"] == 2
    # the JAX count: every leaf of params and batch_stats, gammas included
    assert meta["n_params"] == sum(int(np.size(a)) for a in jax.tree.leaves(art.variables))
    # the weights are in the file
    assert os.path.getsize(art.paths["f32"]) >= 4 * meta["n_params"] * 0.5


def test_graph_holds_only_aten_ops(art):
    for weights in tex.WEIGHT_MODES:
        ops = tex.graph_ops(_load(art, weights)._program)
        assert ops and all(isinstance(t, torch._ops.OpOverload) and t.namespace == "aten"
                           for t in ops), (weights, ops)
    # the resolver that was exported is untouched: still on its kernels' routes
    assert not any(getattr(m, "plain", False) for m in art.resolver.model.modules())


def test_artifact_loads_and_runs_in_a_torch_only_process(art, tmp_path):
    esr = _load(art)
    inputs = _inputs(esr, BATCH, 1)
    torch.save(inputs, tmp_path / "in.pt")
    code = (
        "import sys, torch\n"
        f"program = torch.export.load({art.paths['f32']!r})\n"
        f"inputs = torch.load({str(tmp_path / 'in.pt')!r})\n"
        "with torch.no_grad():\n"
        "    out = program.module()(*inputs)\n"
        f"torch.save(out, {str(tmp_path / 'out.pt')!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('simple_vae_rs_tpu_torch', 'simple_vae_rs_tpu', 'jax', 'numpy'))\n"
        "print(bad)\n"
        "sys.exit(1 if any(m.startswith('simple_vae') or m == 'jax' for m in bad) else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert torch.equal(torch.load(tmp_path / "out.pt"), esr._call(*inputs))


def test_seeded_artifact_equals_the_live_plain_path(art):
    """The same seed, the same noise: a request off the artifact is the live
    resolver's output, ragged and multi-dispatch batches, both endpoints."""
    esr = _load(art, seed=3)
    for b in (3, 4, 6):
        y = _y(b, b, 700)
        got = esr.super_resolve(y, seed=5)
        want = art.resolver.super_resolve(y, seed=5)
        assert got.dtype == torch.float32 and got.shape == (b, PS, PS, C)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    y = _y(8, 6)
    for got, want in zip(esr.super_resolve_moments(y, 3, seed=2),
                         art.resolver.super_resolve_moments(y, 3, seed=2)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    # the rolling generators advance alike
    torch.testing.assert_close(esr.super_resolve(_y(9, 2)),
                               art.resolver.super_resolve(_y(9, 2)), rtol=0, atol=1e-6)


def _rounded(packed):
    """The float32 tensors a packed dict stands for, dequantized in numpy."""
    out = {}
    for name, entry in packed.items():
        if entry[0] == "bf16":
            out[name] = entry[1].float().numpy()
        elif entry[0] == "int8":
            out[name] = entry[1].numpy().astype(np.float32) * entry[2].numpy()
        else:
            out[name] = entry[1].numpy()
    return out


def test_graph_rebuilds_the_packed_tensors_exactly(art):
    """The graph's dequantization (bf16 upcast, int8 times its scale on the
    output-channel axis) is numpy's, bit for bit, and an int8 tensor lies
    within half a step of the weight it stands for in every channel."""
    tensors = dict([*art.tmodel.named_parameters(), *art.tmodel.named_buffers()])
    for weights in tex.WEIGHT_MODES:
        packed = tex._pack_variables(tensors, weights)
        got = tex._Generation(art.tmodel, packed).unpacked()
        assert set(got) == set(tensors)
        for name, want in _rounded(packed).items():
            np.testing.assert_array_equal(got[name].detach().numpy(), want, err_msg=name)
            if packed[name][0] == "int8":
                err = np.abs(want - tensors[name].detach().numpy())
                assert np.all(err <= 0.5001 * packed[name][2].numpy()), name


@pytest.mark.parametrize("weights", ("bf16", "int8"))
def test_compressed_artifact_is_the_live_path_on_its_rounded_weights(art, weights):
    """A bf16 or int8 artifact on a seed is the live resolver on the weights
    the artifact stores (rounded as packed, dequantized in numpy): atol 1e-6.
    Against the f32 artifact alone a wrong dequantization could pass, since
    the outputs respond weakly to the weights."""
    live = SuperResolver(copy.deepcopy(art.tmodel), device="cpu", seed=3)
    tensors = dict([*live.model.named_parameters(), *live.model.named_buffers()])
    with torch.no_grad():
        for name, value in _rounded(tex._pack_variables(tensors, weights)).items():
            tensors[name].copy_(torch.from_numpy(value))
    esr = _load(art, weights, seed=3)
    y = _y(4, 6, 700)
    torch.testing.assert_close(esr.super_resolve(y, seed=5), live.super_resolve(y, seed=5),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("weights", tex.WEIGHT_MODES)
def test_port_artifact_matches_the_jax_artifact(art, weights):
    """The JAX artifact of the same weights on a key, and the port's graph on
    the noise that key draws inside the JAX graph."""
    jres = JSuperResolver(art.jmodel, art.variables, seed=3)
    jpath = str(art.dir / f"jax_{weights}.svrs")
    jexport.export_resolver(jres, jpath, batch=BATCH, platforms=("cpu",), weights=weights)
    jesr = jexport.load_exported(jpath)
    key = jax.random.key_data(jax.random.key(42))
    y = _y(11, BATCH, 700)
    want = np.asarray(jesr._call(jnp.asarray(y), key, jnp.asarray(True)))
    k_u, k_z = jax.random.split(jax.random.wrap_key_data(key))
    shape_u, shape_z = art.tmodel.generation_noise_shapes(BATCH, (WIN, WIN))
    eps_u, eps_z = (torch.from_numpy(np.array(jax.random.normal(k, s, jnp.float32)))
                    for k, s in ((k_u, shape_u), (k_z, shape_z)))
    got = _load(art, weights)._call(torch.from_numpy(y), eps_u, eps_z, torch.tensor(True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # the sidecar: the JAX keys (the lowering platforms aside), the port's format
    jmeta = json.load(open(jpath + ".meta.json"))
    meta = json.load(open(art.paths[weights] + ".meta.json"))
    assert set(meta) == set(jmeta) - {"platforms"}
    assert {k: meta[k] for k in meta if k != "format"} == {
        k: jmeta[k] for k in meta if k != "format"}
    with pytest.raises(ValueError, match="svrs-export"):  # JAX refuses the port's sidecar
        jexport.ExportedResolver(jesr._exported, meta)


def test_packing_is_bit_equal_to_jax(art):
    w = np.random.default_rng(0).normal(size=(3, 3, 8, 16)).astype(np.float32)
    w[..., 5] = 0.0  # a dead channel gets scale 1
    for got, want in zip(tex._rtn_numpy(w), jexport._rtn_numpy(w)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    tvars = {n: t for n, t in art.tmodel.state_dict().items()}
    for mode in ("bf16", "int8"):
        jpacked, _ = jexport._pack_variables(jax.device_get(art.variables), mode)
        jleaves = jax.tree_util.tree_flatten_with_path(jax.device_get(art.variables))[0]
        jnames = [".".join(p.key for p in path[1:]) for path, _ in jleaves]
        tpacked = tex._pack_variables(tvars, mode)
        packed_names = set()
        for name, entry in zip(jnames, jpacked):
            mine = tpacked[name]
            assert mine[0] == entry[0], name
            if entry[0] == "bf16":
                packed_names.add(name)
                np.testing.assert_array_equal(mine[1].view(torch.int16).numpy(),
                                              entry[1].view(np.int16))
            elif entry[0] == "int8":
                packed_names.add(name)
                np.testing.assert_array_equal(mine[1].numpy(), entry[1])
                np.testing.assert_array_equal(mine[2].numpy(), entry[2])
        assert packed_names and all(tpacked[n][0] == "raw" for n in set(tpacked) - packed_names)


# ------------------------------------------------- the cases of test_export.py
def test_super_resolve_shapes_rebatching_and_draws(art):
    esr = _load(art, seed=5)
    rng = np.random.default_rng(1)
    for b in (3, 6):  # padded and trimmed; two dispatches
        out = esr.super_resolve(rng.random((b, WIN, WIN, C)).astype(np.float32))
        assert out.shape == (b, PS, PS, C) and torch.isfinite(out).all()
    one = esr.super_resolve(rng.random((WIN, WIN, C)).astype(np.float32))
    assert one.shape == (1, PS, PS, C)
    y = rng.random((2, WIN, WIN, C)).astype(np.float32)
    assert not torch.allclose(esr.super_resolve(y), esr.super_resolve(y))  # fresh draws
    with pytest.raises(ValueError, match="artifact serves"):
        esr.super_resolve(rng.random((2, 9, 9, C)).astype(np.float32))


def test_rebatched_tail_padding_is_trimmed_consistently(art):
    """Padding repeats the last row, input and noise; its outputs are dropped:
    row 0 of a short request is row 0 of the full batch of its repeats."""
    esr = _load(art)
    y = torch.from_numpy(_y(2, 1))
    eps_u, eps_z = esr._noise(1, (WIN, WIN), torch.Generator().manual_seed(7))
    rep = lambda t: t.expand(BATCH, *t.shape[1:]).contiguous()
    full = esr._call(rep(y), rep(eps_u), rep(eps_z), torch.tensor(True))
    short = esr._dispatch(y, eps_u, eps_z, torch.tensor(True))
    assert short.shape == (1, PS, PS, C)
    assert torch.equal(short[0], full[0])
    # super_resolve draws that noise from a seeded generator
    assert torch.equal(esr.super_resolve(y, seed=7), esr._dispatch(
        y, *esr._noise(1, (WIN, WIN), torch.Generator().manual_seed(7)), torch.tensor(True)))


def test_normalize_flag_is_traced_not_baked(art):
    esr = _load(art)
    y = torch.from_numpy(_y(3, BATCH))
    noise = esr._noise(BATCH, (WIN, WIN), torch.Generator().manual_seed(0))
    on = esr._call(y * 900, *noise, torch.tensor(True))
    off = esr._call(y, *noise, torch.tensor(False))
    # with normalization on the scale cancels: (almost) the flag-off input
    assert torch.allclose(on, off, atol=1e-2)
    assert not torch.equal(on, esr._call(y * 900, *noise, torch.tensor(False)))
    # the per-call override reaches the graph
    assert not torch.equal(esr.super_resolve(y * 900, seed=1),
                           esr.super_resolve(y * 900, normalize=False, seed=1))


def test_super_resolve_moments_rederives_from_sr_graph(art):
    """Moments equal a loop of the graph over the documented noise schedule:
    one draw of the whole batch per sample from the request's generator."""
    esr = _load(art, seed=29)
    y = torch.from_numpy(_y(9, BATCH))
    s1, s2 = esr.super_resolve_moments(y, 3, seed=4)
    assert s1.shape == s2.shape == (BATCH, PS, PS, C)
    gen = torch.Generator().manual_seed(4)
    e1 = e2 = 0
    for _ in range(3):
        out = esr._call(y, *esr._noise(BATCH, (WIN, WIN), gen), torch.tensor(False))
        e1, e2 = e1 + out, e2 + out * out
    assert torch.equal(s1, e1) and torch.equal(s2, e2)
    p1, p2 = esr.super_resolve_moments(y[:3], 2)
    assert p1.shape == p2.shape == (3, PS, PS, C)
    assert float((p2 / 2 - (p1 / 2) ** 2).min()) >= -1e-5
    with pytest.raises(ValueError, match="samples"):
        esr.super_resolve_moments(y, 0)
    with pytest.raises(ValueError, match="artifact serves"):
        esr.super_resolve_moments(np.zeros((2, 9, 9, C), np.float32), 2)


def test_uncertainty_tile_off_artifact_uses_moments_hook(art, monkeypatch):
    esr = _load(art, seed=31)
    monkeypatch.setattr(tex.ExportedResolver, "super_resolve",
                        lambda self, y, normalize=None, seed=None: pytest.fail(
                            "tile UQ fell back to per-draw super_resolve"))
    raster = np.random.default_rng(10).random((16, 16, C)).astype(np.float32)
    maps = esr.uncertainty_tile(raster, samples=4, overlap=0, batch=BATCH)
    assert maps["mean"].shape == (32, 32, C) and (maps["variance"] >= 0).all()


def test_uncertainty_and_mmse(art):
    esr = _load(art, seed=9)
    y = _y(4, 1)[0]
    maps = esr.uncertainty(y, samples=6)
    assert maps["mean"].shape == (PS, PS, C) and (maps["variance"] >= 0).all()
    torch.testing.assert_close(maps["std"] ** 2, maps["variance"], rtol=0, atol=1e-6)
    assert esr.mmse_estimate(y, samples=4).shape == (PS, PS, C)
    # seeded: reproducible, and each slot an independent draw of the graph
    a, b = esr.uncertainty(y, samples=6, seed=2), esr.uncertainty(y, samples=6, seed=2)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="samples"):
        esr.uncertainty(y, samples=1)


def test_tile_endpoints_run_off_the_artifact(art):
    esr = _load(art, seed=11)
    raster = np.random.default_rng(5).random((20, 26, C)).astype(np.float32)
    sr = esr.super_resolve_tile(raster, batch=BATCH)
    assert sr.shape == (40, 52, C) and np.isfinite(sr).all()
    assert esr.uncertainty_tile(raster, samples=3, batch=BATCH)["mean"].shape == (40, 52, C)
    mn = raster.min(axis=(0, 1), keepdims=True)
    mx = raster.max(axis=(0, 1), keepdims=True)
    norm = (raster - mn) / (mx - mn + 1e-5)
    rows = []
    for r0, block in esr.iter_tile_rows(lambda a, b: norm[a:b], 20, 26, batch=BATCH):
        assert r0 == sum(x.shape[0] for x in rows)
        rows.append(block)
    assert np.concatenate(rows).shape == (40, 52, C)


def test_artifact_seeded_tile_reproducible(art):
    esr = _load(art)
    raster = np.random.default_rng(3).random((12, 18, C)).astype(np.float32)
    a = esr.super_resolve_tile(raster, overlap=2, batch=BATCH, seed=7)
    np.testing.assert_array_equal(a, esr.super_resolve_tile(raster, overlap=2, batch=BATCH,
                                                            seed=7))
    assert not np.array_equal(a, esr.super_resolve_tile(raster, overlap=2, batch=BATCH, seed=8))
    ua = esr.uncertainty_tile(raster, samples=3, overlap=2, batch=BATCH, seed=9)
    ub = esr.uncertainty_tile(raster, samples=3, overlap=2, batch=BATCH, seed=9)
    np.testing.assert_array_equal(ua["std"], ub["std"])


def test_missing_sidecar_and_bad_meta(art, tmp_path):
    orphan = tmp_path / "orphan.pt2"
    orphan.write_bytes(open(art.paths["f32"], "rb").read())
    with pytest.raises(FileNotFoundError, match="meta.json"):
        tex.load_exported(str(orphan), device="cpu")
    program = _load(art)._program
    with pytest.raises(ValueError, match="svrs-torch-export"):
        tex.ExportedResolver(program, {"format": "something-else"})
    # the JAX package's artifact is refused by its sidecar, before its blob is read
    orphan.with_name("orphan.pt2.meta.json").write_text(json.dumps({"format": "svrs-export/1"}))
    with pytest.raises(ValueError, match="JAX package's StableHLO artifact"):
        tex.load_exported(str(orphan), device="cpu")


def test_exported_resolver_serves_on_the_card_by_default(art):
    """A resolver built without a device, directly or through
    ``load_exported``, is placed on the card: on a host without one it
    raises rather than serve on the CPU."""
    meta = json.load(open(art.paths["f32"] + ".meta.json"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tex.ExportedResolver(art.programs["f32"], meta)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tex.load_exported(art.paths["f32"])
    esr = _load(art)
    assert esr.device.type == "cpu"
    assert all(t.device.type == "cpu" for t in esr._program.state_dict.values())


def test_export_refuses_a_bad_batch_and_weight_mode(art):
    with pytest.raises(ValueError, match="weights must be one of"):
        tex._pack_variables(dict(art.tmodel.state_dict()), "fp16")
    with pytest.raises(ValueError, match="batch"):
        tex.export_resolver(art.resolver, str(art.dir / "x.pt2"), batch=0)


def test_weight_compressed_artifacts(art):
    """bf16 and int8: smaller files, the same graph contract, within
    quantization noise of the f32 artifact on the same inputs."""
    ref_esr = _load(art)
    inputs = _inputs(ref_esr, BATCH, 21)
    ref = ref_esr._call(*inputs).numpy()
    span = float(ref.max() - ref.min()) or 1.0
    sizes = {w: os.path.getsize(p) for w, p in art.paths.items()}
    for mode, floor in (("bf16", 45.0), ("int8", 30.0)):
        assert json.load(open(art.paths[mode] + ".meta.json"))["weights"] == mode
        out = _load(art, mode)._call(*inputs).numpy()
        assert out.shape == ref.shape and np.isfinite(out).all()
        psnr = 10 * np.log10(span * span / max(float(np.mean((out - ref) ** 2)), 1e-20))
        assert psnr > floor, (mode, psnr)
    assert sizes["int8"] < sizes["bf16"] < sizes["f32"]


def test_w8a8_and_bf16_models_export_as_they_serve(art, tmp_path):
    """A W8A8 resolver exports its float weights (the int8 ones dropped, as
    JAX drops ``quant``), an ``int8_weights`` one the dequantized weights it
    serves; a bfloat16 model exports its bfloat16 graph with float32
    outputs, equal to its live plain path on a seed."""
    from simple_vae_rs_tpu_torch.config import CondSRVAEConfig
    from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
    from simple_vae_rs_tpu_torch.ops import quantize as qz

    w8 = SuperResolver(art.tmodel, device="cpu", int8=True)
    assert qz.has_quant(w8.model)
    want = tex._plain_copy(art.resolver).state_dict()
    ww = SuperResolver(art.tmodel, device="cpu", int8_weights=True)
    served = {**want, **{n: qz.dequantize(q, s) for n, (q, s) in ww._packed.items()}}
    for resolver, expect in ((w8, want), (ww, served)):
        plain = tex._plain_copy(resolver)
        assert not qz.has_quant(plain)
        got = plain.state_dict()
        assert set(got) == set(expect) and all(torch.equal(got[k], expect[k]) for k in expect)
    bf = CondSRVAE(CondSRVAEConfig(cr=2.0, patch_size=PS), dtype=torch.bfloat16)
    bf.load_state_dict(art.tmodel.state_dict())
    live = SuperResolver(bf, device="cpu")
    path = tex.export_resolver(live, str(tmp_path / "bf.pt2"), batch=BATCH)
    got = tex.load_exported(path, device="cpu").super_resolve(_y(6, 3, 300), seed=2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, live.super_resolve(_y(6, 3, 300), seed=2), rtol=0,
                               atol=1e-6)


def test_export_checkpoint_cli_roundtrip(art, tmp_path, capsys):
    from simple_vae_rs_tpu_torch import Trainer
    from simple_vae_rs_tpu_torch.train.checkpoint import save_checkpoint

    tr = Trainer(art.tmodel, device="cpu")
    ckpt = str(tmp_path / "model")
    save_checkpoint(ckpt, tr, epoch=1, extra={"model": tr._model_meta()})
    out = str(tmp_path / "model.pt2")
    assert tex.main([ckpt, out, "--batch", "2", "--verify", "--backend", "cpu",
                     "--no_normalize"]) == 0
    printed = capsys.readouterr().out
    assert "verify: super_resolve((2, 8, 8, 4)) -> (2, 16, 16, 4) on cpu" in printed
    esr = tex.load_exported(out, device="cpu")
    assert esr.batch == 2 and esr.normalize is False
    assert esr.super_resolve(np.zeros((2, WIN, WIN, C), np.float32)).shape == (2, PS, PS, C)


# ----------------------------------------------------------------- serving
JAX_ARTIFACT_HEALTH = {"status", "model", "patch_size", "channels", "artifact", "batch",
                       "platforms", "moments", "seed", "wire_u16"}


def test_http_server_serves_from_artifact(art):
    import io
    import urllib.request

    from simple_vae_rs_tpu_torch.client import Client

    esr = _load(art, seed=13)
    srv = server.make_server(esr, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        c = Client(url, timeout=120)
        health = c.health()
        assert set(health) == JAX_ARTIFACT_HEALTH
        assert health["artifact"] is True and health["model"] == "CondSRVAE"
        assert (health["patch_size"], health["channels"], health["batch"]) == (PS, C, BATCH)
        assert health["platforms"] == ["cpu"] and health["moments"] is True
        y = _y(6, 2)
        # a seeded request over HTTP is the in-process artifact's bits
        np.testing.assert_array_equal(c.super_resolve(y, seed=5),
                                      esr.super_resolve(y, seed=5).numpy())
        s1, s2 = c.super_resolve_moments(_y(30, 2), samples=3)
        assert s1.shape == (2, PS, PS, C) and float((s2 / 3 - (s1 / 3) ** 2).min()) >= -1e-5
        raster = np.random.default_rng(7).random((18, 22, C)).astype(np.float32)
        buf = io.BytesIO()
        np.save(buf, raster)
        req = urllib.request.Request(url + "/v1/uncertainty_tile?samples=3&batch=4",
                                     data=buf.getvalue(),
                                     headers={"Content-Type": "application/x-npy"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            maps = np.load(io.BytesIO(resp.read()), allow_pickle=False)
        assert maps["mean"].shape == (36, 44, C) and (maps["variance"] >= 0).all()
    finally:
        srv.shutdown()
        srv.server_close()


def test_server_cli_rejects_baked_flags_with_artifact(art, capsys):
    for extra in (["--int8"], ["--int8_weights"], ["--pallas_conv"], ["--mesh_data", "2"],
                  ["-cr", "2"], ["--patch_size", "16"], ["--channels", "4"],
                  ["--latent_size", "256"], ["--model_type", "SRVAE"]):
        with pytest.raises(SystemExit):
            server.main(["--artifact", art.paths["f32"], "--backend", "cpu", *extra])
        assert "cannot apply to --artifact" in capsys.readouterr().err
    with pytest.raises(SystemExit):  # exactly one source
        server.main(["--artifact", art.paths["f32"], "--model_ckpt", "x"])


def test_server_main_serves_an_artifact(art, monkeypatch):
    """``server.main --artifact``: loads, warms up and serves the artifact."""
    made = {}

    def fake_make_server(resolver, *a, **k):
        made["resolver"] = resolver
        raise KeyboardInterrupt  # stop before serve_forever

    monkeypatch.setattr(server, "make_server", fake_make_server)
    with pytest.raises(KeyboardInterrupt):
        server.main(["--artifact", art.paths["int8"], "--backend", "cpu"])
    esr = made["resolver"]
    assert isinstance(esr, tex.ExportedResolver) and esr.meta["weights"] == "int8"
    assert esr.device.type == "cpu"


def test_raster_stream_cli_against_artifact_server(art, tmp_path):
    """``raster --url`` against an artifact-backed server: its bytes are the
    artifact's own tile product on the same request seed."""
    from simple_vae_rs_tpu_torch import raster
    from simple_vae_rs_tpu_torch.data.tiffio import read_tiff, write_tiff

    esr = _load(art, seed=17)
    srv = server.make_server(esr, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        lr = (np.random.default_rng(22).random((21, 19, C)) * 900).astype(np.uint16)
        src, dst, mem = (str(tmp_path / n) for n in ("lr.tif", "sr.tif", "mem.tif"))
        write_tiff(src, lr)
        raster.main([src, dst, "--url", url, "--batch", "4", "--stream"])
        out = read_tiff(dst)
        assert out.shape == (42, 38, C) and out.dtype == np.uint16
        raster.main([src, mem, "--url", url, "--batch", "4", "--request_seed", "3"])
        f = lr.astype(np.float32)
        mn = f.min(axis=(0, 1), keepdims=True)
        denom = f.max(axis=(0, 1), keepdims=True) - mn + raster._EPS
        sr = esr.super_resolve_tile(f, batch=4, seed=3)
        np.testing.assert_array_equal(read_tiff(mem), raster._cast_like(sr * denom + mn,
                                                                        np.uint16))
    finally:
        srv.shutdown()
        srv.server_close()
