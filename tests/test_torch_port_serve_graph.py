"""``SuperResolver.uncertainty`` as one CUDA graph replay a request.

On the CPU (tier-1): a resolver on the CPU, one in the weights-only int8
mode and one over a CPU device mesh never capture and serve the eager
request; the graph's body (``serve.RequestGraph``: its static noise drawn
as the eager path draws it, then the model's ``sample`` with the noise
passed in, the image normalized inside it) is the eager request bit for
bit, the generator left where the eager request leaves it; the graphs held
stay within ``MAX_GRAPHS`` and a new key past it waits its turn.

On the card (marker ``gpu``, skipped without one): the replayed maps are
the eager maps (``tasks.sample_chunked`` on the resolver's model with the
same generator, then the moments) bit for bit, in the plain, chained and
W8A8 modes and in both dtypes, seeded and on the rolling generator; the
maps are the caller's own; weights loaded in place show in the next
replay; the graph and launch counters; the bound over many draw counts;
a capture that raises. The file
imports neither JAX nor the JAX package:
``pytest --noconftest -m gpu tests/test_torch_port_serve_graph.py``.
"""

import warnings

import numpy as np
import pytest
import torch

from simple_vae_rs_tpu_torch.config import CondSRVAEConfig, MeshConfig
from simple_vae_rs_tpu_torch.models.cond_vae import CondSRVAE
from simple_vae_rs_tpu_torch.models.srvae import SRVAE
from simple_vae_rs_tpu_torch.ops import fused_conv as fc
from simple_vae_rs_tpu_torch.ops import fused_int8 as f8
from simple_vae_rs_tpu_torch.parallel.mesh import make_mesh
from simple_vae_rs_tpu_torch.serve import (
    COUNTED_KEYS,
    MAX_GRAPHS,
    RequestGraph,
    SuperResolver,
    _launch_cells,
    _moments,
)
from simple_vae_rs_tpu_torch.tasks import auto_chunk, sample_chunked

PS = 16
CFG = CondSRVAEConfig(cr=2.0, patch_size=PS)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
MODES = {"plain": {}, "chain": {"chain": True}, "int8": {"int8": True}}
MAPS = ("mean", "std", "variance")


def _lr(seed: int, hw: int = PS // 2) -> np.ndarray:
    return np.random.default_rng(seed).random((hw, hw, 4)).astype(np.float32)


def _eager(sr: SuperResolver, y, gen: torch.Generator, samples: int,
           chunk=None) -> dict:
    """The eager request: the resolver's input, ``tasks.sample_chunked`` on
    its model (its packed weights unpacked), then the moments."""
    yin = sr._input(y, sr.normalize)[:1]
    if chunk is None:
        chunk = auto_chunk(samples, int(yin.shape[1]) * 2)
    return _moments(sample_chunked(sr.model, yin, gen, samples=samples, chunk=chunk,
                                   packed=sr._packed))


def _assert_equal(got: dict, want: dict) -> None:
    for k in MAPS:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), (k, float((got[k] - want[k]).abs().max()))


def _counts() -> list:
    return [counts[name] for counts, name in _launch_cells()]


def _reset() -> None:
    fc.reset_launches()
    f8.reset_launches()


# ------------------------------------------------------------------ the CPU
@pytest.mark.parametrize("mode", ["cpu", "int8_weights", "mesh"])
def test_resolvers_off_the_graph_path_never_capture(mode):
    """The CPU, the weights-only int8 mode and a device mesh serve eagerly:
    no capture and no replay, and the maps of today's eager request (the
    mesh's within 1e-6 of the one-device resolver's, as its own tests hold
    it), seeded and on the rolling generator."""
    model = CondSRVAE(CFG).init_weights(0)
    kw = {"int8_weights": True} if mode == "int8_weights" else {}
    if mode == "mesh":
        sr = SuperResolver(model, seed=1, mesh=make_mesh(MeshConfig(data=2), ["cpu", "cpu"]))
    else:
        sr = SuperResolver(model, device="cpu", seed=1, **kw)
    twin = SuperResolver(model, device="cpu", seed=1, **kw)
    y = _lr(3)
    for seed in (5, 5, None, None):
        got = sr.uncertainty(y, samples=6, chunk=4, seed=seed)
        if mode == "mesh":
            want = twin.uncertainty(y, samples=6, chunk=4, seed=seed)
            for k in MAPS:
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)
        else:
            _assert_equal(got, _eager(twin, y, twin._generator(seed), 6, 4))
    assert sr.graph_captures == sr.graph_replays == 0 and sr.graphs == {}


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "normalized"])
@pytest.mark.parametrize("samples,chunk", [(20, 8), (5, 5)], ids=["partial", "one"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "srvae_hr"])
def test_graph_body_is_the_eager_request(kind, samples, chunk, normalize):
    """What the card captures, run eagerly on the CPU: the raw image loaded,
    the static noise (``eps_u``, then a whole chunk of ``eps_z`` at a time,
    the last chunk too) and ``sample`` with it passed in, normalized in the
    body where the resolver normalizes, give the eager request's maps bit
    for bit, and leave the generator where the eager request leaves it. The
    SRVAE takes an HR-sized image, downsampled inside the body."""
    if kind == "srvae_hr":
        model, hw = SRVAE(CFG).init_weights(1), PS
    else:
        model, hw = CondSRVAE(CFG, dtype=DTYPES[kind]).init_weights(1), PS // 2
    sr = SuperResolver(model, device="cpu", normalize=normalize)
    y = torch.from_numpy(_lr(2, hw))[None] * 3.0
    gen, ref = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    g = RequestGraph.static(sr.model, tuple(y.shape), samples, chunk, normalize,
                            torch.device("cpu"))
    assert g.eps_z.shape[0] == -(-samples // chunk) * chunk and g.host is None
    g.load(y)
    g.draw(gen)
    got = g.generate(sr.model)
    want = sample_chunked(sr.model, sr._input(y, normalize), ref, samples=samples, chunk=chunk)
    _assert_equal(got, _moments(want))
    assert torch.equal(gen.get_state(), ref.get_state())


def _admitted(sr: SuperResolver, keys) -> int:
    """The captures a stream of request keys makes under ``_admits``, a
    placeholder standing in for each captured graph."""
    captures = 0
    for key in keys:
        if sr._admits(key) and key not in sr.graphs:
            sr.graphs[key] = object()
            captures += 1
        assert len(sr.graphs) <= MAX_GRAPHS
    return captures


@pytest.mark.parametrize("traffic", ["one_off", "cycle", "new_favourite", "forgotten"])
def test_the_graphs_are_bounded_and_one_off_keys_never_captured(traffic):
    """At most ``MAX_GRAPHS`` graphs: the first keys capture while there is
    room; then a key asked for once is served eagerly, a cycle over one key
    more than the bound captures nothing more, a key asked for more often
    than the least recently used one takes its place, and so does a key
    asked for twice once the held key has left the counted keys."""
    sr = SuperResolver(CondSRVAE(CFG).init_weights(0), device="cpu")
    held = [("held", i) for i in range(MAX_GRAPHS)]
    assert _admitted(sr, held) == MAX_GRAPHS
    if traffic == "one_off":
        assert _admitted(sr, [("once", i) for i in range(50)]) == 0
        assert list(sr.graphs) == held
    elif traffic == "cycle":
        assert _admitted(sr, (held + [("fifth",)]) * 10) == 0
        assert ("fifth",) not in sr.graphs
    elif traffic == "new_favourite":
        _admitted(sr, held[1:] * 3)  # held[0] stays the least recently used, asked once
        assert _admitted(sr, [("new",)]) == 0
        assert _admitted(sr, [("new",)]) == 1
        assert list(sr.graphs) == held[1:] + [("new",)]
    else:
        _admitted(sr, held * 3)
        assert _admitted(sr, [("other", i) for i in range(COUNTED_KEYS)]) == 0
        assert _admitted(sr, [("back",)] * 2) == 1
        assert ("back",) in sr.graphs and held[0] not in sr.graphs
    assert len(sr.graphs) == MAX_GRAPHS and len(sr._requests) <= COUNTED_KEYS


# ------------------------------------------------------------------ the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _model(dtype, seed: int = 1, cfg: CondSRVAEConfig = CFG) -> CondSRVAE:
    return CondSRVAE(cfg, device="cuda", dtype=dtype).init_weights(seed)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_replayed_maps_are_the_eager_maps(cuda, dtype, mode):
    """Each captured mode in each dtype: the first request of a key (served
    by the run before its capture) and the replays after it equal the eager
    request with the same generator bit for bit, at 20 draws in chunks of 8
    (the last one partial) and at 1000 draws in the default chunk; two
    unseeded requests in a row equal a second resolver's of the same seed."""
    model = _model(DTYPES[dtype])
    sr = SuperResolver(model, device=cuda, seed=4, **MODES[mode])
    y = _lr(11)
    for samples, chunk in ((20, 8), (1000, None)):
        for seed in (2, 2, 3):
            _assert_equal(sr.uncertainty(y, samples, chunk, seed=seed),
                          _eager(sr, y, _gen(seed), samples, chunk))
    assert sr.graph_captures == 2 and sr.graph_replays == 4
    rolling = SuperResolver(model, device=cuda, seed=4, **MODES[mode])
    twin = SuperResolver(model, device=cuda, seed=4, **MODES[mode])
    for _ in range(2):
        _assert_equal(rolling.uncertainty(y, 20, 8), _eager(twin, y, twin._rng, 20, 8))
    assert rolling.graph_replays == 1
    assert torch.equal(rolling._rng.get_state(), twin._rng.get_state())


@pytest.mark.gpu
def test_canonical_bf16_request_replays_bit_for_bit(cuda):
    """The benchmark's request: the canonical Cond_SRVAE in bfloat16 (the
    wide ``conv_wg_bf16`` shapes), one 32x32 LR window, 1000 draws."""
    cfg = CondSRVAEConfig(cr=1.2, patch_size=64)
    sr = SuperResolver(_model(torch.bfloat16, 0, cfg), device=cuda)
    y = _lr(12, 32)
    for seed in (7, 8, 9):
        _assert_equal(sr.uncertainty(y, 1000, seed=seed), _eager(sr, y, _gen(seed), 1000))
    assert sr.graph_captures == 1 and sr.graph_replays == 2


@pytest.mark.gpu
def test_maps_are_the_callers_own_and_loaded_weights_show(cuda):
    """A request's maps stay as they were after the next requests (clones,
    not the graph's outputs), and weights loaded in place into the served
    model show in the next replay, with no capture."""
    sr = SuperResolver(_model(torch.bfloat16), device=cuda)
    y = _lr(5)
    first = sr.uncertainty(y, 20, 8, seed=1)
    second = sr.uncertainty(y, 20, 8, seed=2)
    kept = {k: v.clone() for k, v in second.items()}
    third = sr.uncertainty(y, 20, 8, seed=3)
    for k in MAPS:
        assert torch.equal(second[k], kept[k]) and not torch.equal(second[k], third[k]), k
    _assert_equal(first, _eager(sr, y, _gen(1), 20, 8))
    _assert_equal(second, _eager(sr, y, _gen(2), 20, 8))
    sr.model.load_state_dict(_model(torch.bfloat16, 9).state_dict())
    got = sr.uncertainty(y, 20, 8, seed=2)
    assert sr.graph_captures == 1 and sr.graph_replays == 3
    _assert_equal(got, _eager(sr, y, _gen(2), 20, 8))
    assert not torch.equal(got["mean"], second["mean"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,mode", [("f32", "plain"), ("bf16", "int8")])
def test_replays_count_what_eager_requests_launch(cuda, dtype, mode):
    """n requests of one shape: one capture and n - 1 replays, and the launch
    counters (float and int8 kernels) read what n eager requests launch; a
    new shape or draw count captures again."""
    sr = SuperResolver(_model(DTYPES[dtype]), device=cuda, **MODES[mode])
    y = _lr(6)
    _eager(sr, y, _gen(0), 20, 8)  # builds the kernels
    _reset()
    for i in range(3):
        _eager(sr, y, _gen(i), 20, 8)
    torch.cuda.synchronize()
    eager = _counts()
    assert sum(eager) > 0
    for replays in (2, 5):
        _reset()
        for i in range(3):
            sr.uncertainty(y, 20, 8, seed=i)
        torch.cuda.synchronize()
        assert _counts() == eager
        assert sr.graph_captures == 1 and sr.graph_replays == replays
    sr.uncertainty(_lr(6, 16), 20, 8)
    sr.uncertainty(y, 21, 8)
    assert sr.graph_captures == 3 and len(sr.graphs) == 3


@pytest.mark.gpu
def test_many_sample_counts_hold_at_most_max_graphs(cuda):
    """Requests of a dozen draw counts, each once: the first ``MAX_GRAPHS``
    capture, the rest are served eagerly, every one equal to the eager
    request; a count asked for twice then takes the least recently used
    graph's place, and the graphs' pools go back to the card with them."""
    sr = SuperResolver(_model(torch.bfloat16), device=cuda)
    y = _lr(10)
    for samples in range(8, 20):
        _assert_equal(sr.uncertainty(y, samples, 4, seed=samples),
                      _eager(sr, y, _gen(samples), samples, 4))
    assert sr.graph_captures == len(sr.graphs) == MAX_GRAPHS and sr.graph_replays == 0
    _assert_equal(sr.uncertainty(y, 19, 4, seed=1), _eager(sr, y, _gen(1), 19, 4))
    assert sr.graph_captures == MAX_GRAPHS + 1 and len(sr.graphs) == MAX_GRAPHS
    assert [k[1] for k in sr.graphs] == [9, 10, 11, 19]
    _assert_equal(sr.uncertainty(y, 19, 4, seed=2), _eager(sr, y, _gen(2), 19, 4))
    assert sr.graph_replays == 1
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # what is left reserved: the graphs' pools and static tensors
    held = torch.cuda.memory_reserved()
    sr.graphs.clear()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() < held


@pytest.mark.gpu
def test_int8_weights_on_the_card_stays_eager(cuda):
    """The weights-only int8 mode unpacks its weights into new tensors each
    request, which a graph would not see: it never captures."""
    model = _model(torch.float32)
    sr = SuperResolver(model, device=cuda, seed=2, int8_weights=True)
    twin = SuperResolver(model, device=cuda, seed=2, int8_weights=True)
    y = _lr(8)
    for seed in (1, 1, None):
        _assert_equal(sr.uncertainty(y, 20, 8, seed=seed),
                      _eager(twin, y, twin._generator(seed), 20, 8))
    assert sr.graph_captures == sr.graph_replays == 0 and sr.graphs == {}


@pytest.mark.gpu
def test_a_capture_that_raises_is_warned_and_served_eagerly(cuda):
    """A host sync inside the request makes its capture fail: one warning,
    the request served by the run before the capture, its key eager from
    then on (no second capture, no warning); the rolling generator draws on
    as a second resolver's, the card's default generator still draws, and a
    key captured before still replays."""
    model = _model(torch.float32)
    sr = SuperResolver(model, device=cuda, seed=3)
    twin = SuperResolver(model, device=cuda, seed=3)
    y = _lr(7)
    sr.uncertainty(y, 20, 8, seed=1)
    real = sr.model.sample

    def syncing(*a, **k):
        out = real(*a, **k)
        float(out.sum())  # a copy to the host and a wait for it
        return out

    sr.model.sample = syncing
    with pytest.warns(RuntimeWarning, match="served eagerly"):
        got = sr.uncertainty(y, 12, 4)
    del sr.model.sample
    _assert_equal(got, _eager(twin, y, twin._rng, 12, 4))
    assert [k for k, g in sr.graphs.items() if g is None] == [((1, 8, 8, 4), 12, 4, True,
                                                              torch.float32, False, False,
                                                              False)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _assert_equal(sr.uncertainty(y, 12, 4), _eager(twin, y, twin._rng, 12, 4))
    assert sr.graph_captures == 2 and sr.graph_replays == 0
    assert torch.isfinite(torch.randn(8, device=cuda)).all()
    _assert_equal(sr.uncertainty(y, 20, 8, seed=1), _eager(sr, y, _gen(1), 20, 8))
    assert sr.graph_replays == 1


@pytest.mark.gpu
def test_a_replayed_request_opens_two_spans(cuda):
    """Under a profiler, the capturing request's spans hold the whole eager
    request (prior, decode, conv spans); a replayed one opens
    ``svrs.uq.replay`` inside ``svrs.uq.request``, and no span below it."""
    sr = SuperResolver(_model(torch.bfloat16), device=cuda)
    y = _lr(9)
    names = []
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            sr.uncertainty(y, 20, 8, seed=1)
        names.append([e.name for e in prof.events() if e.name.startswith("svrs.")])
    capture, replay = names
    assert capture.count("svrs.uq.capture") == 1 and "svrs.uq.prior" in capture
    assert "svrs.conv" in capture and "svrs.uq.replay" not in capture
    assert sorted(replay) == ["svrs.uq.input", "svrs.uq.replay", "svrs.uq.request"]
