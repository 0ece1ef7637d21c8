"""The port's recurrent units against the JAX package's, on the CPU:
``causal_conv1d`` with its carry, the mLSTM (chunkwise prefill over two
chunks, from a carried state, then decode; and split over the sequence
on simulated ranks, as a sharded prefill runs it), the sLSTM and the
RG-LRU (from a carried h), each in float32 and bfloat16, weights drawn by
``repro_torch.models.weights.numpy_params`` for both packages.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.models import recurrent as trec, transformer as tt, weights  # noqa: E402

# tests/test_torch_models.py's tolerances (see there)
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2**-6, atol=2**-4)}
DTYPES = tuple(TOL)
JAX_PARAMS = {"mlstm": jrec.MLSTMParams, "slstm": jrec.SLSTMParams, "rglru": jrec.RGLRUParams}


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def close(got, want, dtype, what=""):
    np.testing.assert_allclose(f32(got), f32(want), err_msg=what, **TOL[dtype])


def held(got, want, dtype, what, ref32=None):
    """``close``; or, given the JAX package's float32 run ``ref32``, the
    bfloat16 spread rule of tests/test_torch_models.py (BF16_SPREAD): the
    port's largest and mean |error| against it no more than 1.5 times the
    JAX package's own bfloat16 run's."""
    if ref32 is None:
        return close(got, want, dtype, what)
    mine, theirs = (np.abs(f32(a) - f32(ref32)) for a in (got, want))
    for stat in (np.max, np.mean):
        assert stat(mine) <= 1.5 * stat(theirs), (what, stat.__name__, stat(mine),
                                                 stat(theirs))


def close_cache(got, want, dtype, what):
    for name in want._fields:
        close(getattr(got, name), getattr(want, name), dtype, f"{what} {name}")


def unit_pair(arch, kind, dtype, seed=3):
    """The JAX and the port's configs and params of the first ``kind`` unit
    of ``arch``'s REDUCED superblock."""
    jcfg = jreg.get_config(arch, reduced=True).replace(dtype=dtype)
    tcfg = treg.get_config(arch, reduced=True).replace(dtype=dtype)
    _, sb, _, _ = tt.block_program(tcfg)
    j = [u.kind for u in sb].index(kind)
    fields = {k: v[0] for k, v in weights.numpy_params(tcfg, seed)["main"][j].items()}
    jp = JAX_PARAMS[kind](**{k: jnp.asarray(v) for k, v in fields.items()})
    return jcfg, tcfg, jp, tt.unit_params(tcfg, sb[j], fields, getattr(torch, dtype))


def pair(a, dtype):
    """numpy -> (the JAX array, the torch tensor) in ``dtype``."""
    return jnp.asarray(a, dtype), torch.as_tensor(a).to(getattr(torch, dtype))


def carried(rng, cache, dtype, scale=1.0):
    """A cache of random values in the JAX cache's layout, for both."""
    jc, tc = {}, {}
    for name in cache._fields:
        leaf = getattr(cache, name)
        a = rng.standard_normal(leaf.shape, dtype=np.float32) * scale
        jc[name], tc[name] = pair(a, "float32" if leaf.dtype == jnp.float32 else dtype)
    return type(cache)(**jc), tc


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv1d_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x, w, prev = (rng.standard_normal(s, dtype=np.float32)
                  for s in ((2, 10, 16), (4, 16), (2, 3, 16)))
    for carry in (None, prev):
        jargs = [pair(a, dtype)[0] for a in (x, w)]
        targs = [pair(a, dtype)[1] for a in (x, w)]
        jy, jprev = jrec.causal_conv1d(*jargs, None if carry is None else pair(carry, dtype)[0])
        ty, tprev = trec.causal_conv1d(*targs, None if carry is None else pair(carry, dtype)[1])
        close(ty, jy, dtype, "conv")
        close(tprev, jprev, dtype, "carry out")


def mlstm_vs_reference(dtype):
    """Prefill over two 256-token chunks from a carried (C, n, conv), the
    new cache, then decode steps (the two apply hd ** -0.5 otherwise, as
    the JAX package does).  In bfloat16 the prefill's output is held by
    the spread rule (``held``): at S = 512 two right bfloat16 runs differ
    past TOL where a head's group norm divides by a small RMS, each run
    far off the float32 value there.  An AssertionError where a check is
    broken."""
    jcfg, tcfg, jp, tp = unit_pair("xlstm-1.3b", "mlstm", dtype)
    rng = np.random.default_rng(1)
    jc, tc = carried(rng, jrec.mlstm_cache_init(jcfg, 2, jnp.dtype(dtype)), dtype, 0.5)
    tc = trec.MLSTMCache(**tc)
    x = rng.standard_normal((2, 2 * trec.MLSTM_CHUNK, tcfg.d_model), dtype=np.float32)
    prefill = jax.jit(lambda p, x, c, cfg: jrec.mlstm_apply(p, x, cfg, c), static_argnums=3)
    jy, jc32 = prefill(jp, pair(x, dtype)[0], jc, jcfg)
    ref32 = None
    if dtype == "bfloat16":
        jp32 = type(jp)(*(a.astype(jnp.float32) for a in jp))
        c32 = type(jc)(*(a.astype(jnp.float32) for a in jc))
        ref32, _ = prefill(jp32, jnp.asarray(x), c32, jcfg.replace(dtype="float32"))
    jc = jc32
    ty, tc = trec.mlstm_apply(tp, pair(x, dtype)[1], tcfg, tc)
    held(ty, jy, dtype, "prefill", ref32)
    close_cache(tc, jc, dtype, "prefill cache")
    step = jax.jit(lambda p, x, c: jrec.mlstm_apply(p, x, jcfg, c, decode=True))
    for s in range(3):
        xt = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
        jy, jc = step(jp, pair(xt, dtype)[0], jc)
        ty, tc = trec.mlstm_apply(tp, pair(xt, dtype)[1], tcfg, tc, decode=True)
        close(ty, jy, dtype, f"decode step {s}")
    close_cache(tc, jc, dtype, "decode cache")


@pytest.mark.parametrize("dtype", DTYPES)
def test_mlstm_matches_reference(dtype):
    """``mlstm_vs_reference`` holds."""
    mlstm_vs_reference(dtype)


def test_mlstm_spread_rule_fails_a_planted_fault(monkeypatch):
    """The bfloat16 spread rule fails a wrong mLSTM: the carried state C0
    scaled by hd ** -0.5 inside a chunk (as decode scales q)."""
    chunk = trec._mlstm_chunk
    monkeypatch.setattr(trec, "_mlstm_chunk", lambda C0, n0, q, k, v, i, logf, scale: chunk(
        C0 * scale, n0, q, k, v, i, logf, scale))
    with pytest.raises(AssertionError, match="prefill"):
        mlstm_vs_reference("bfloat16")


def test_mlstm_length_rule():
    """A sequence longer than a chunk must be a whole number of them, where
    the JAX package asserts."""
    _, tcfg, _, tp = unit_pair("xlstm-1.3b", "mlstm", "float32")
    with pytest.raises(ValueError, match="chunks of 256"):
        trec.mlstm_apply(tp, torch.zeros((1, 300, tcfg.d_model)), tcfg)


def split_scan(bounds, whole=trec._mlstm_scan):
    """``recurrent._mlstm_scan`` (``whole``) as a prefill split over the
    sequence runs it, ranks simulated in one process: rank r holds tokens
    bounds[r] to bounds[r + 1], runs them from the zero state
    (``mlstm_run_end``), and scans them from the exclusive prefix of the
    runs before it (``mlstm_carry``); the state after the last token is
    the prefix of every run."""

    def scan(q, k, v, i, logf, C0, n0, scale):
        parts = [slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]
        runs = [trec.mlstm_run_end(*(t[:, s] for t in (k, v, i, logf))) for s in parts]
        hs = [whole(*(t[:, s] for t in (q, k, v, i, logf)), *trec.mlstm_carry(C0, n0, runs[:r]),
                    scale)[0] for r, s in enumerate(parts)]
        return (torch.cat(hs, dim=1), *trec.mlstm_carry(C0, n0, runs))

    return scan


SPLIT_S = 1024  # four chunks: whole ones on 2 and 4 ranks


@functools.cache
def split_case():
    """The REDUCED mLSTM unit in float32 (the port's params), x [2, SPLIT_S,
    D] and a carried (C, n, conv) for the port, and the JAX package's
    ``mlstm_apply`` output and cache on the same numpy inputs."""
    jcfg, tcfg, jp, tp = unit_pair("xlstm-1.3b", "mlstm", "float32")
    rng = np.random.default_rng(4)
    jc, tc = carried(rng, jrec.mlstm_cache_init(jcfg, 2, jnp.float32), "float32", 0.5)
    x = rng.standard_normal((2, SPLIT_S, tcfg.d_model), dtype=np.float32)
    jy, jc = jax.jit(lambda p, x, c: jrec.mlstm_apply(p, x, jcfg, c))(jp, jnp.asarray(x), jc)
    return tcfg, tp, x, tc, jy, jc


def split_vs_reference(monkeypatch, bounds):
    """``split_case``'s unit with its scan split at ``bounds``
    (``split_scan``): the scan's h and state against ``_mlstm_scan`` whole,
    the unit's output and cache against the JAX package's ``mlstm_apply``,
    each at TOL."""
    tcfg, tp, x, tc, jy, jc = split_case()
    seen, whole = {}, trec._mlstm_scan

    def scan(*args, scale):
        seen["split"] = split_scan(bounds, whole)(*args, scale)
        seen["whole"] = whole(*args, scale)
        return seen["split"]

    monkeypatch.setattr(trec, "_mlstm_scan", scan)
    ty, tc = trec.mlstm_apply(tp, torch.as_tensor(x), tcfg, trec.MLSTMCache(**tc))
    for got, want, what in zip(seen["split"], seen["whole"], ("h", "C", "n")):
        close(got, want, "float32", f"{what} against the whole scan")
    close(ty, jy, "float32", "unit against the JAX package")
    close_cache(tc, jc, "float32", "cache against the JAX package")


@pytest.mark.parametrize("ranks", [2, 4])
def test_mlstm_split_over_the_sequence_equals_the_whole_scan(monkeypatch, ranks):
    """1,024 tokens (four chunks) over 2 and 4 simulated ranks, each a run
    of whole chunks: the split scan with its prefix of states is the whole
    scan and the JAX package's unit (``split_vs_reference``)."""
    split_vs_reference(monkeypatch, [r * SPLIT_S // ranks for r in range(ranks + 1)])


def test_mlstm_split_that_cuts_a_chunk_fails(monkeypatch):
    """Planted: the split at token 640, inside the third chunk, so that
    rank 1's chunks start 128 tokens off the multiples of 256: the
    reference's scale quirk (hd ** -0.5 on the intra-chunk scores only)
    moves the output off the whole scan's, and the check fails."""
    with pytest.raises(AssertionError, match="against the whole scan"):
        split_vs_reference(monkeypatch, [0, 640, SPLIT_S])


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_matches_reference(dtype):
    """The loop over time from the initial state (the stabilizer at -10),
    then decode steps; the cache after each."""
    jcfg, tcfg, jp, tp = unit_pair("xlstm-1.3b", "slstm", dtype)
    assert tp.r.dtype == tp.b.dtype == torch.float32
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, tcfg.d_model), dtype=np.float32)
    jy, jc = jax.jit(lambda p, x: jrec.slstm_apply(p, x, jcfg))(jp, pair(x, dtype)[0])
    ty, tc = trec.slstm_apply(tp, pair(x, dtype)[1], tcfg)
    close(ty, jy, dtype, "prefill")
    close_cache(tc, jc, dtype, "prefill cache")
    step = jax.jit(lambda p, x, c: jrec.slstm_apply(p, x, jcfg, c, decode=True))
    for s in range(3):
        xt = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
        jy, jc = step(jp, pair(xt, dtype)[0], jc)
        ty, tc = trec.slstm_apply(tp, pair(xt, dtype)[1], tcfg, tc, decode=True)
        close(ty, jy, dtype, f"decode step {s}")
    close_cache(tc, jc, dtype, "decode cache")


@pytest.mark.parametrize("dtype", DTYPES)
def test_rglru_matches_reference(dtype):
    """The scan from a carried h and conv (the carry as the pseudo-step),
    with Lambda drawn so that a state lasts tens of steps, then decode."""
    jcfg, tcfg, jp, tp = unit_pair("recurrentgemma-9b", "rglru", dtype)
    assert tp.lam.dtype == torch.float32
    rng = np.random.default_rng(3)
    jc, tc = carried(rng, jrec.rglru_cache_init(jcfg, 2, jnp.dtype(dtype)), dtype)
    tc = trec.RGLRUCache(**tc)
    x = rng.standard_normal((2, 40, tcfg.d_model), dtype=np.float32)
    jy, jc2 = jax.jit(lambda p, x, c: jrec.rglru_apply(p, x, jcfg, c))(jp, pair(x, dtype)[0], jc)
    ty, tc2 = trec.rglru_apply(tp, pair(x, dtype)[1], tcfg, tc)
    close(ty, jy, dtype, "prefill")
    close_cache(tc2, jc2, dtype, "prefill cache")
    # the carried h reaches the last step: zeroing it moves the output there
    _, j0 = jrec.rglru_apply(jp, pair(x, dtype)[0], jcfg, jc._replace(h=jnp.zeros_like(jc.h)))
    assert float(jnp.abs(j0.h - jc2.h).max()) > 1e-3
    step = jax.jit(lambda p, x, c: jrec.rglru_apply(p, x, jcfg, c, decode=True))
    for s in range(3):
        xt = rng.standard_normal((2, 1, tcfg.d_model), dtype=np.float32)
        jy, jc2 = step(jp, pair(xt, dtype)[0], jc2)
        ty, tc2 = trec.rglru_apply(tp, pair(xt, dtype)[1], tcfg, tc2, decode=True)
        close(ty, jy, dtype, f"decode step {s}")
    close_cache(tc2, jc2, dtype, "decode cache")


@pytest.mark.parametrize("S", [1, 2, 7, 64])
def test_linear_scan_is_the_loop(S):
    """The log-depth scan against the step-by-step recurrence, in float64."""
    rng = np.random.default_rng(S)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, S, 8)))
    b = torch.as_tensor(rng.standard_normal((2, S, 8)))
    h0 = torch.as_tensor(rng.standard_normal((2, 8)))
    h, want = h0, []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(trec.linear_scan(a, b, h0).numpy(),
                               torch.stack(want, 1).numpy(), rtol=1e-12, atol=1e-12)


# ------------------------------------------- the RG-LRU split over "model"
RGLRU_SPLIT = (2, 2)  # the gloo ranks' mesh: "data" x "model"
RGLRU_GRADS = ("w_in", "w_gate", "w_rg", "w_ig", "w_out", "lam", "conv_w")


@functools.cache
def rglru_case():
    """REDUCED recurrentgemma-9b's first RG-LRU unit in float32 (its
    fields as numpy), x [4, 40, D], a carried cache (h, conv) and the
    upstream gradients of the output and of the new cache, from numpy."""
    tcfg = treg.get_config("recurrentgemma-9b", reduced=True).replace(dtype="float32")
    _, sb, _, _ = tt.block_program(tcfg)
    j = [u.kind for u in sb].index("rglru")
    fields = {k: v[0] for k, v in weights.numpy_params(tcfg, 5)["main"][j].items()}
    rng = np.random.default_rng(6)
    R, W, B, S = tcfg.rglru_width, tcfg.conv1d_width, 4, 40

    def draw(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    return {"j": j, "fields": fields, "x": draw(B, S, tcfg.d_model),
            "cache": {"h": draw(B, R), "conv": draw(B, W - 1, R)},
            "up": {"y": draw(B, S, tcfg.d_model), "h": draw(B, R), "conv": draw(B, W - 1, R)}}


def rglru_loss_terms(y, cache, up):
    """sum(y * dy) + sum(h * dh) + sum(conv * dconv): its gradients are the
    vector-Jacobian products of the upstream gradients ``up``."""
    return ((y * up["y"]).sum() + (cache.h * up["h"]).sum()
            + (cache.conv * up["conv"]).sum())


@functools.cache
def rglru_jax(carried: bool) -> dict:
    """The JAX package's ``rglru_apply`` on ``rglru_case`` (from its cache
    or from none): the output, the new cache and ``jax.grad`` of
    ``rglru_loss_terms`` by x and by each weight, as numpy."""
    case = rglru_case()
    jcfg = jreg.get_config("recurrentgemma-9b", reduced=True).replace(dtype="float32")
    jp = jrec.RGLRUParams(**{k: jnp.asarray(v) for k, v in case["fields"].items()})
    c = jrec.RGLRUCache(**{k: jnp.asarray(v) for k, v in case["cache"].items()}) \
        if carried else None
    up = {k: jnp.asarray(v) for k, v in case["up"].items()}

    def loss(p, x):
        y, new = jrec.rglru_apply(p, x, jcfg, c)
        return rglru_loss_terms(y, new, up), (y, new)

    (_, (y, new)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(case["x"]))
    return {"y": f32(y), "h": f32(new.h), "conv": f32(new.conv), "grad_x": f32(gx),
            **{f"grad_{f}": f32(getattr(gp, f)) for f in RGLRU_GRADS}}


def rglru_port(carried: bool, mesh=None) -> dict:
    """The port's ``rglru_apply`` on ``rglru_case`` as ``rglru_jax`` reads
    it: on plain tensors (whole R), or over ``mesh`` (a "process" mesh of
    this gloo group) with each weight laid out by the production rule and
    x, the cache and the upstream gradients as the batch's rows (the
    channel split, which it asserts was taken)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.dist import sharding
    from repro_torch.models import common

    case = rglru_case()
    tcfg = treg.get_config("recurrentgemma-9b", reduced=True).replace(dtype="float32")
    p = tt.unit_params(tcfg, tt.Unit("rglru"), case["fields"], torch.float32,
                       master=torch.float32)
    x = torch.from_numpy(case["x"]).requires_grad_(True)
    cache = {k: torch.from_numpy(v) for k, v in case["cache"].items()}
    up = {k: torch.from_numpy(v) for k, v in case["up"].items()}
    xs, split = x, []
    if mesh is not None:
        dm = mesh.to_device_mesh()
        specs = sharding.param_specs(tcfg, mesh)
        for f in trec.RGLRUParams.FIELDS:
            name = f"main.{case['j']}.{f}"
            p._parameters[f] = torch.nn.Parameter(
                sharding.distribute(p._parameters[f], mesh, sharding.port_spec(name, specs[name])))

        def rows(t):
            return common.batch_layout(DTensor.from_local(t, dm, [Replicate()] * dm.ndim,
                                                          run_check=False))
        xs, cache, up = rows(x), {k: rows(v) for k, v in cache.items()}, \
            {k: rows(v) for k, v in up.items()}
        orig = trec._rglru_on_channels

        def watched(*args):
            split.append(True)
            return orig(*args)
        trec._rglru_on_channels = watched
    try:
        with implicit_replication():
            y, new = trec.rglru_apply(p, xs, tcfg, trec.RGLRUCache(**cache) if carried else None)
            rglru_loss_terms(y, new, up).backward()
    finally:
        if mesh is not None:
            trec._rglru_on_channels = orig
    assert split == ([True] if mesh is not None else [])

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().numpy()

    return {"y": whole(y), "h": whole(new.h), "conv": whole(new.conv),
            "grad_x": x.grad.numpy(),
            **{f"grad_{f}": whole(p._parameters[f].grad) for f in RGLRU_GRADS}}


RGLRU_RANKS = """
    init()
    import test_torch_recurrent as t
    from repro_torch.launch import mesh as tmesh

    mesh = tmesh.make_mesh_like(t.RGLRU_SPLIT)
    out = {f"{carried}/{k}": v for carried in (False, True)
           for k, v in t.rglru_port(carried, mesh).items()}
    np.savez(OUT, **out)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def rglru_ranks(tmp_path_factory):
    """The gloo ranks' split runs (rank 0's arrays), by "carried/key"."""
    from test_torch_collectives import run_ranks

    return run_ranks(RGLRU_RANKS, math.prod(RGLRU_SPLIT), tmp_path_factory.mktemp("rglru"))[0]


@pytest.mark.parametrize("carried", [False, True], ids=["from-zero", "carried"])
def test_rglru_split_over_channels_equals_the_whole_r_run(rglru_ranks, carried):
    """REDUCED recurrentgemma-9b's RG-LRU on 4 gloo ranks ("data" 2 x
    "model" 2: each rank its rows and R / 2 channels, the weights laid out
    by the production rule), from no cache (training) and from a carried
    one (a prefill): its output, its new cache (h, conv) and the gradients
    of x and of every weight but the norm scale through the split path
    equal the port's one-device run at whole R and the JAX package's
    ``rglru_apply`` and ``jax.grad``, in float32, at TOL."""
    want, whole = rglru_jax(carried), rglru_port(carried)
    for k, w in want.items():
        got = rglru_ranks[f"{carried}/{k}"]
        close(got, whole[k], "float32", f"{k}: the split against the whole-R run")
        close(got, w, "float32", f"{k}: the split against the JAX package")
        close(whole[k], w, "float32", f"{k}: the whole-R run against the JAX package")


@pytest.mark.parametrize("S", [1, 2, 255, 256, 4097])
def test_linear_scan_gradient_is_the_jax_packages(S):
    """The scan's backward (the reverse recurrence, ``_LinearScan``) through
    REDUCED recurrentgemma-9b's RG-LRU unit, B 1 x S tokens from a carried
    h in float32: the gradients of x, of the carried h and of each weight
    against ``jax.grad`` of the JAX package's ``rglru_apply`` (its
    ``lax.associative_scan``), at TOL."""
    jcfg, tcfg, jp, tp = unit_pair("recurrentgemma-9b", "rglru", "float32", seed=S)
    tp = tt.unit_params(tcfg, tt.Unit("rglru"), {k: np.array(f32(v)) for k, v in jp._asdict().items()},
                        torch.float32, master=torch.float32)
    rng = np.random.default_rng(S)
    x, dy = (rng.standard_normal((1, S, tcfg.d_model), dtype=np.float32) for _ in range(2))
    h0 = rng.standard_normal((1, tcfg.rglru_width), dtype=np.float32)
    conv = np.zeros((1, tcfg.conv1d_width - 1, tcfg.rglru_width), np.float32)

    def jloss(p, x, h):
        y, c = jrec.rglru_apply(p, x, jcfg, jrec.RGLRUCache(h=h, conv=jnp.asarray(conv)))
        return (y * dy).sum() + c.h.sum()

    gp, gx, gh = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jp, jnp.asarray(x), jnp.asarray(h0))
    tx, th = (torch.from_numpy(a).requires_grad_(True) for a in (x, h0))
    y, c = trec.rglru_apply(tp, tx, tcfg, trec.RGLRUCache(h=th, conv=torch.from_numpy(conv)))
    ((y * torch.from_numpy(dy)).sum() + c.h.sum()).backward()
    close(tx.grad, gx, "float32", "x")
    close(th.grad, gh, "float32", "carried h")
    for f in RGLRU_GRADS:
        close(tp._parameters[f].grad, getattr(gp, f), "float32", f)
