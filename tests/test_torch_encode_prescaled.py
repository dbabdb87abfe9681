"""The fused pow2 pre-scale + encode pass (``posit_encode_prescaled``).

* Against the JAX package: ``_pow2_scale`` then ``posit_encode(x / s)``
  (interpret mode) give the same scale and, bit for bit, the same words
  as the port's fused function on the CPU (its plain version), on P8, P16
  and P32, bounded and unbounded, with and without pre-scale.
* The plan of ``csrc/posit_encode.cu`` (``_encode_plan``): its launches
  cover every value once, and the kernel's f64 fixed-order reduction,
  emulated here over the plan, rounds to the same scale as
  ``_pow2_scale``, ties included.
* The route: the cuda backend on CPU tensors gives the SMOKE model the same
  logits, bit for bit, as the route it replaced (``_pow2_scale``, a
  divide, the plain encode).
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma2_2b as JG
from repro.core import engine as JE
from repro.core import posit as JP
from repro.kernels import posit_codec as JPC
from repro.models.transformer import Model as JModel
from repro_torch.configs import gemma2_2b as TG
from repro_torch.core import engine as TE
from repro_torch.core import posit as TP
from repro_torch.core.engine import from_variant as t_variant
from repro_torch.kernels import _build
from repro_torch.kernels import ops as TOps
from repro_torch.kernels import posit_codec as TPC
from repro_torch.models.layers import Ctx as TCtx
from repro_torch.models.transformer import Model as TModel, params_from_jax
from repro_torch.numerics import NumericsContext as TN
from repro_torch.numerics import backends as TB

torch.set_num_threads(1)

FORMATS = [(JP.POSIT8, TP.POSIT8), (JP.BPOSIT8, TP.BPOSIT8),
           (JP.POSIT16, TP.POSIT16), (JP.BPOSIT16, TP.BPOSIT16),
           (JP.POSIT32, TP.POSIT32), (JP.BPOSIT32, TP.BPOSIT32)]
IDS = [j.name for j, _ in FORMATS]
CSRC = Path(TPC.__file__).resolve().parent / "csrc" / "posit_encode.cu"


def _smoke_weights() -> list[tuple[np.ndarray, torch.Tensor]]:
    """Every parameter of the SMOKE model from the JAX ``Model.init``, with
    its counterpart carried across by ``params_from_jax``; the embedding
    also transposed, as the tied head contracts it."""
    jp = jax.tree.map(np.asarray, JModel(JG.SMOKE, remat=False).init(
        jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, TG.SMOKE, device="cpu")
    pairs = [(jp["embed"]["e"], tp["embed"]["e"]),
             (np.ascontiguousarray(jp["embed"]["e"].T),
              tp["embed"]["e"].t().contiguous()),
             (jp["ln_f"]["g"], tp["ln_f"]["g"])]

    def walk(jtree, ttree, i):
        if isinstance(ttree, dict):
            for k in ttree:
                walk(jtree[k], ttree[k], i)
        else:
            pairs.append((jtree[i], ttree))

    for i, layer in enumerate(tp["layers"]):
        walk(jp["layers"], layer, i)
    return pairs


def _ragged() -> list[np.ndarray]:
    """Sizes below one vector and off a multiple of 4, magnitudes over
    2^[-6, 6)."""
    rng = np.random.default_rng(11)
    out = []
    for n in (1, 2, 3, 5, 6, 7, 37, 1023, 4097):
        x = rng.normal(size=n).astype(np.float32)
        out.append(x * np.exp2(rng.integers(-6, 6, size=n)).astype(np.float32))
    return out


def _edges() -> list[np.ndarray]:
    """All zeros (count 0, scale 1); zeros, NaN and values that go
    subnormal after the scale among normals; Inf (the scale is Inf)."""
    rng = np.random.default_rng(12)
    big = (rng.normal(size=300) * 2.0 ** 10).astype(np.float32)
    big[:8] = [0.0, -0.0, np.nan, -np.nan, 2.0 ** -120, -(2.0 ** -121),
               2.0 ** -126, 3e38]
    small = (rng.normal(size=77) * 2.0 ** -9).astype(np.float32)
    small[::7] = 0.0
    small[3] = np.nan
    with_inf = rng.normal(size=9).astype(np.float32)
    with_inf[[2, 5]] = [np.inf, -np.inf]
    with_inf[7] = np.nan
    return [np.zeros(7, np.float32), np.zeros((3, 5), np.float32), big,
            small, with_inf]


def _inputs(kind: str) -> list[np.ndarray]:
    if kind == "weights":
        return [j for j, _ in _smoke_weights()]
    return _ragged() if kind == "ragged" else _edges()


def _mean_lg(x: np.ndarray) -> float:
    ax = np.abs(x.astype(np.float64))
    nz = ax >= 2.0 ** -126
    return float(np.log2(ax[nz]).mean()) if nz.any() else 0.0


@pytest.mark.parametrize("kind", ["weights", "ragged", "edges"])
@pytest.mark.parametrize("pre_scale", [True, False])
@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
def test_fused_encode_matches_jax(jpc, tpc, pre_scale, kind):
    """Scale equal and words bit-identical to the JAX package's
    ``_pow2_scale`` and interpret-mode ``posit_encode(x / s)``.  Every
    finite mean log2 magnitude here lies inside +-12: beyond it XLA:CPU's
    ``exp2`` is not exact (ROADMAP queue 3) and the packages' scales
    differ."""
    xs = _inputs(kind)
    if kind == "weights":
        pairs = _smoke_weights()
        ts = [t for _, t in pairs]
        assert all(np.array_equal(t.numpy(), j) for j, t in pairs)
    else:
        ts = [torch.from_numpy(x.copy()) for x in xs]
    scaled, want_s = [], []
    for x in xs:
        m = _mean_lg(x)
        assert not np.isfinite(m) or abs(m) <= 12, m
        s = JE._pow2_scale(jnp.asarray(x)) if pre_scale else jnp.float32(1)
        want_s.append(float(s))
        scaled.append(np.asarray(jnp.asarray(x) / s if pre_scale
                                 else jnp.asarray(x)).reshape(-1))
    # the JAX encode is elementwise: one interpret-mode call for all
    want = np.asarray(JPC.posit_encode(jnp.asarray(np.concatenate(scaled)),
                                       jpc, block=4096, interpret=True))
    _build.reset_launches()
    off = 0
    for t, s_want, x in zip(ts, want_s, xs):
        words, s = TPC.posit_encode_prescaled(t, tpc, pre_scale)
        assert words.dtype == torch.int32 and words.shape == t.shape
        assert s.dtype == torch.float32 and s.dim() == 0
        assert float(s) == s_want, (x.shape, float(s), s_want)
        np.testing.assert_array_equal(
            words.numpy().reshape(-1).view(np.uint32),
            want[off:off + x.size])
        off += x.size
    assert _build.LAUNCHES["posit_encode_prescaled"] == 0   # plain version
    if kind == "edges" and pre_scale:
        assert want_s[:2] == [1.0, 1.0] and want_s[-1] == np.inf


# --------------------------------------------------------------------------
# The plan of csrc/posit_encode.cu, emulated
# --------------------------------------------------------------------------

def _thread_steps(n: int, head: int, G: int) -> list[np.ndarray]:
    """What each of the G threads of a launch takes at each step of its
    loop, in the kernel's order (-1: none): its head value ([G]), the
    float4 vectors of its grid-stride loop, UNROLL at a time ([G, 4]: x, y,
    z, w), its tail value ([G])."""
    U = TPC.UNROLL
    gt = np.arange(G, dtype=np.int64)
    h = min(head, n)
    steps = [np.where(gt < h, gt, -1)]
    nv = (n - h) // 4
    for v0 in range(0, nv, U * G):
        for u in range(U):
            vi = (gt + v0 + u * G)[:, None]
            steps.append(np.where(vi < nv, h + 4 * vi + np.arange(4), -1))
    t0 = h + 4 * nv
    steps.append(np.where(gt < n - t0, t0 + gt, -1))
    return steps


def _launches(plan) -> list[tuple[int, int]]:
    """(blocks, threads) of each launch of the plan."""
    return [(plan.encode_blocks, TPC.ENC_THREADS)] + (
        [(plan.reduce_blocks, TPC.RED_THREADS)] if plan.reduce_blocks else [])


def _tree(v: np.ndarray) -> np.ndarray:
    """block_total: element t adds t + stride, stride = T/2, ..., 1."""
    v = v.copy()
    st = v.shape[-1] // 2
    while st:
        v[..., :st] += v[..., st:2 * st]
        st //= 2
    return v[..., 0]


def _kernel_scale(x: torch.Tensor, head: int = 0) -> np.float32:
    """The fused kernel's scale, emulated: per-thread f64 sums in the plan's
    order (a vector's four terms first added in f32 as (x + y) + (z + w))
    with exact counts, the fixed trees, then f32 as _pow2_scale."""
    return _encode_scale(*_reduce_partials(x, head))


def _reduce_partials(x: torch.Tensor, head: int = 0):
    """The reduce launch, emulated: its per-block (f64 sum, int64 count)
    partials."""
    ax = x.reshape(-1).to(torch.float32).abs()
    normal = ax >= 2.0 ** -126      # XLA's flush: subnormals do not count
    nz = normal.numpy()
    lg = torch.where(normal, torch.log2(ax), torch.zeros(())).numpy()
    n = ax.numel()
    plan = TPC._encode_plan(n)

    def launch_sums(blocks, T):
        s = np.zeros(blocks * T)
        c = np.zeros(blocks * T, dtype=np.int64)
        for idx in _thread_steps(n, head, blocks * T):
            ok = idx >= 0
            terms = np.where(ok, lg[np.where(ok, idx, 0)], np.float32(0))
            if idx.ndim == 2:
                terms = (terms[:, 0] + terms[:, 1]) + (terms[:, 2]
                                                       + terms[:, 3])
                c += (ok & nz[np.where(ok, idx, 0)]).sum(1)
            else:
                c += ok & nz[np.where(ok, idx, 0)]
            s += terms.astype(np.float64)
        return _tree(s.reshape(blocks, T)), _tree(c.reshape(blocks, T))

    return launch_sums(plan.reduce_blocks, TPC.RED_THREADS)


def _encode_scale(ps: np.ndarray, pc: np.ndarray) -> np.float32:
    """The encode launch's scale from partials, emulated: thread t adds
    partials t, t + T, ..., the fixed tree, then f32 as _pow2_scale."""
    T = TPC.ENC_THREADS
    a, k = np.zeros(T), np.zeros(T, dtype=np.int64)
    for i in range(0, len(ps), T):   # thread t: t, t + T, ...
        m = min(T, len(ps) - i)
        a[:m] += ps[i:i + m]
        k[:m] += pc[i:i + m]
    total, count = _tree(a), _tree(k)
    mean = np.float32(total) / np.float32(max(int(count), 1))
    return np.maximum(np.exp2(np.rint(mean)), np.float32(1e-30))


def test_plan_constants_match_the_kernel():
    # the geometry and the reduce launch live in the header that
    # posit_encode.cu shares with posit_core_codec.cu's guard entries
    src = CSRC.read_text() + (CSRC.parent / "posit_prescale.cuh").read_text()
    for name in ("ENC_THREADS", "RED_THREADS", "UNROLL", "BLOCKS_PER_SM"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(TPC, name), name
    assert src.count("__launch_bounds__(ENC_THREADS, BLOCKS_PER_SM)") == 1
    assert src.count("__launch_bounds__(RED_THREADS, BLOCKS_PER_SM)") == 1
    # both grids are at most one wave of resident blocks
    assert TPC.ENC_MAX_BLOCKS == TPC.RED_MAX_BLOCKS == \
        TPC.BLOCKS_PER_SM * TPC.N_SMS


def _boundaries() -> list[int]:
    # where a launch goes from one to 2 and 4 blocks, and to a full wave
    U, vec = TPC.UNROLL, 4
    red, enc = vec * U * TPC.RED_THREADS, vec * U * TPC.ENC_THREADS
    edges = [vec, red, 2 * red, 4 * red, red * TPC.RED_MAX_BLOCKS,
             enc, 2 * enc, 4 * enc, enc * TPC.ENC_MAX_BLOCKS]
    return sorted({0, 1, 2, 3, 5} | {e + d for e in edges for d in (-1, 0, 1)})


@pytest.mark.parametrize("n", _boundaries())
@pytest.mark.parametrize("pre_scale", [True, False])
def test_plan_covers_every_value_once(n, pre_scale):
    """Each launch of the plan takes every value exactly once, whatever the
    base's offset from a 16-byte boundary (head 0-3 values)."""
    plan = TPC._encode_plan(n, pre_scale)
    assert plan == TPC._encode_plan(n, pre_scale)
    assert 1 <= plan.encode_blocks <= TPC.ENC_MAX_BLOCKS
    assert (plan.reduce_blocks == 0) == (not pre_scale)
    assert plan.reduce_blocks <= TPC.RED_MAX_BLOCKS
    for head in range(4):
        for blocks, T in _launches(plan):
            idx = np.concatenate([i.reshape(-1) for i in
                                  _thread_steps(n, head, blocks * T)])
            got = np.bincount(idx[idx >= 0], minlength=n)
            assert got.shape == (n,) and bool((got == 1).all()), (head, T)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 4096, 32768, 32769, 100003,
                               1 << 20, 2_000_003])
def test_kernel_reduction_rounds_like_pow2_scale(n):
    """The emulated f64 fixed-order reduction gives _pow2_scale's scale on
    random tensors, at every head offset for the smaller ones."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * np.exp2(rng.integers(-9, 9, size=n))
         * 2.0 ** rng.uniform(-8, 8)).astype(np.float32)
    x[rng.random(n) < 0.05] = 0.0
    t = torch.from_numpy(x)
    want = float(TE._pow2_scale(t))
    for head in (range(4) if n < 200_000 else (0,)):
        assert float(_kernel_scale(t, head)) == want, head


@pytest.mark.parametrize("n", [2, 6, 4096, 65536, 1 << 20, 2_000_000])
@pytest.mark.parametrize("lo,hi,want", [(1.0, 2.0, 1.0), (2.0, 4.0, 4.0),
                                        (0.5, 1.0, 1.0), (0.25, 0.5, 0.25)])
def test_kernel_reduction_ties_round_half_even(n, lo, hi, want):
    """Half the values 2^a and half 2^(a+1): the mean log2 is exactly
    a + 0.5 in every order, and both round half to even (0.5 -> 0,
    1.5 -> 2, -0.5 -> -0, -1.5 -> -2).  Zeros and NaN do not count."""
    x = np.full(n, lo, np.float32)
    x[1::2] = -hi
    x = np.concatenate([x, [0.0, np.nan, -0.0]]).astype(np.float32)
    t = torch.from_numpy(x)
    assert float(TE._pow2_scale(t)) == want
    for head in (0, 3):
        assert float(_kernel_scale(t, head)) == want


def _split_scale(x: torch.Tensor, parts: int = 2) -> np.float32:
    """The split entry's scale for ``x``'s rows cut into ``parts`` ranks'
    tensors, emulated: each rank's reduce launch, its partials summed to
    one (sum, count) pair (``posit_codec._launch_grouped``), the pairs
    summed over the group, the encode launch on that one pair."""
    total, count = np.float64(0.0), 0
    for piece in torch.chunk(x, parts):
        ps, pc = _reduce_partials(piece)
        total += ps.sum()
        count += int(pc.sum())
    return _encode_scale(np.array([total]), np.array([count], np.int64))


@pytest.mark.parametrize("n", [2, 4096, 65536, 1 << 20])
@pytest.mark.parametrize("lo,hi,want", [(1.0, 2.0, 1.0), (2.0, 4.0, 4.0),
                                        (0.5, 1.0, 1.0), (0.25, 0.5, 0.25)])
def test_split_reduction_gives_the_whole_tensors_scale(n, lo, hi, want):
    """The split entry over two halves of a tensor: the halves' partials
    summed over the group round like _pow2_scale of the whole tensor,
    on random tensors whose halves' own scales differ, and at .5 ties."""
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, n)) * np.exp2(rng.integers(-9, 9, size=(2, n)))
         ).astype(np.float32)
    x[1] *= np.float32(2.0 ** 5)          # the second half's own scale
    x[rng.random((2, n)) < 0.05] = 0.0
    t = torch.from_numpy(x)
    assert float(_split_scale(t)) == float(TE._pow2_scale(t))
    assert float(_kernel_scale(t[0])) != float(TE._pow2_scale(t))
    ties = np.full((2, n), lo, np.float32)
    ties[:, 1::2] = -hi
    t = torch.from_numpy(ties)
    assert float(TE._pow2_scale(t)) == want
    assert float(_split_scale(t)) == want


# --------------------------------------------------------------------------
# The route
# --------------------------------------------------------------------------

class _ParentRoute(TB.CudaBackend):
    """The cuda backend's pre-scaled contraction as it was before the fused
    pass: ``_pow2_scale`` of each operand, a divide, then the plain encode
    of the quotient inside ``euler_matmul_fused``."""

    name = "parent_route"

    def dot_general(self, a, b, dimension_numbers, cfg):
        pair = TB._single_contraction(a, b, dimension_numbers)
        if pair is None:     # batched qk / pv: the reference engine
            return TB.LaxRefBackend.dot_general(self, a, b,
                                                dimension_numbers, cfg)
        assert cfg.mode == "euler" and cfg.pre_scale
        a2, b2 = pair
        K = a2.shape[-1]
        lhs_free, rhs_free = tuple(a2.shape[:-1]), tuple(b2.shape[1:])
        af = a2.reshape(-1, K).to(torch.float32)
        bf = b2.reshape(K, -1).to(torch.float32)
        sa, sb = TE._pow2_scale(af), TE._pow2_scale(bf)
        out = TOps.euler_matmul_fused(af / sa, bf / sb, cfg) * (sa * sb)
        return out.reshape(lhs_free + rhs_free).to(cfg.dtype)


def test_cuda_route_on_cpu_matches_the_parent_route():
    """SMOKE prefill and three decode steps: the cuda backend's logits
    equal the parent route's bit for bit, and no kernel launch is
    counted."""
    ecfg = t_variant(16, "L-21b")
    assert ecfg.pre_scale
    TB.register_backend("parent_route", _ParentRoute())
    tp = params_from_jax(
        jax.tree.map(np.asarray, JModel(JG.SMOKE, remat=False).init(
            jax.random.PRNGKey(0))), TG.SMOKE, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, TG.SMOKE.vocab, (2, 16)).astype(np.int32))
    logits = {}
    _build.reset_launches()
    for backend in ("cuda", "parent_route"):
        nctx = TN.from_ecfg(ecfg, backend=backend)
        m, ctx = TModel(TG.SMOKE, numerics=nctx, device="cpu"), \
            TCtx(numerics=nctx)
        cache = m.init_cache(2, 32, "uint16")
        seq = []
        lg, cache = m.prefill(tp, ids, ctx, cache)
        seq.append(lg)
        pos = torch.tensor([16, 16], dtype=torch.int32)
        for _ in range(3):
            tok = seq[-1].argmax(-1).to(torch.int32)
            lg, cache = m.decode_step(tp, tok, pos, cache, ctx)
            seq.append(lg)
            pos = pos + 1
        logits[backend] = torch.stack(seq)
    assert bool(torch.isfinite(logits["cuda"]).all())
    assert torch.equal(logits["cuda"], logits["parent_route"])
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_prescaled_matmul_matches_engine_on_cpu(rng):
    """ops.euler_matmul_prescaled against the reference engine's pre-scaled
    euler_dot_general (within the bar of test_numerics.py:279)."""
    tc = t_variant(16, "L-21b")
    x = torch.from_numpy((rng.normal(size=(5, 64)) * 30).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 24)) / 50).astype(np.float32))
    got = TOps.euler_matmul_prescaled(x, w, tc)
    want = TE.euler_dot_general(x, w, (((1,), (0,)), ((), ())), tc)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-3)


# --------------------------------------------------------------------------
# The table form of the encode (csrc/posit_common.cuh: encode_entry,
# encode_by_entry), emulated
# --------------------------------------------------------------------------

def _entries(pc) -> np.ndarray:
    """encode_entry for e8 = 0..255: [256, 4] (base, ehi, half, shifts)."""
    G, N, es = 26, pc.n_bits, pc.es
    rcap, kmax, kmin = pc.rcap, pc.k_max, pc.k_min
    out = np.zeros((256, 4), np.int64)
    for e8 in range(256):
        scale = e8 - 127
        if scale > pc.max_scale or scale < pc.min_scale:
            out[e8] = ((1 << (N - 1)) - 1 if scale > pc.max_scale else 1,
                       0, 0, 31)
            continue
        k = scale >> es
        e = scale - k * (1 << es)
        pos, at_hi, at_lo = k >= 0, k == kmax, k == kmin
        mid = ((1 << (k + 1)) - 1) << 1 if pos else 1
        if pc.bounded:
            w = (rcap if at_hi else k + 2) if pos else (
                rcap if at_lo else -k + 1)
            rb = ((1 << rcap) - 1 if at_hi else mid) if pos else (
                0 if at_lo else 1)
        else:
            w = (N - 1 if at_hi else k + 2) if pos else -k + 1
            rb = (1 << (N - 1)) - 1 if (pos and at_hi) else mid
        t = N - 1 - w
        sh = es + G - t
        S = min(sh, 31)
        out[e8] = ((rb << max(t, 0)) & 0xFFFFFFFF, e << G,
                   ((1 << (S - 1)) - 1) if sh > 0 else 0,
                   (S | 1 << 16) if sh > 0 else min(-sh, 31) << 8)
    return out


def _encode_by_entry(bits: np.ndarray, tab: np.ndarray, pc) -> np.ndarray:
    N, m32 = pc.n_bits, 0xFFFFFFFF
    e8 = (bits >> 23) & 0xFF
    base, ehi, half, shifts = (tab[e8, i] for i in range(4))
    S, L = shifts & 0xFF, (shifts >> 8) & 0xFF
    T = ((ehi | ((bits & 0x7FFFFF) << 3)) << L) & m32
    lsb = (T >> S) & (shifts >> 16)
    body = (base + (((T + half + lsb) & m32) >> S)) & m32
    body = np.clip(body, 1, (1 << (N - 1)) - 1)
    pat = np.where(bits >> 31 == 1, (-body) & ((1 << N) - 1), body)
    pat = np.where(e8 == 0, 0, pat)
    return np.where(e8 == 255, 1 << (N - 1), pat)


@pytest.mark.parametrize("jpc,tpc", FORMATS, ids=IDS)
def test_encode_table_form_matches_encode_body(jpc, tpc):
    """The table form gives encode_body's pattern for every f32 exponent
    and sign with fractions that exercise every rounding cut: each single
    bit, its neighbours and the ties at every position, and random ones."""
    rng = np.random.default_rng(5)
    cuts = [v for c in range(24) for v in ((1 << c), (1 << c) - 1,
                                          (1 << c) + 1, 3 << c)]
    fracs = np.unique(np.concatenate([
        np.asarray(cuts, np.int64) & 0x7FFFFF, [0, 0x7FFFFF],
        rng.integers(0, 1 << 23, 2000)]))
    e8 = np.arange(256, dtype=np.int64)
    bits = ((e8[:, None, None] << 23) | fracs[None, :, None]
            | (np.array([0, 1], np.int64) << 31)[None, None, :]).reshape(-1)
    x = torch.from_numpy(bits.astype(np.uint32).view(np.float32))
    want = TPC.encode_body(x, tpc).numpy()
    got = _encode_by_entry(bits, _entries(tpc), tpc)
    np.testing.assert_array_equal(got, want)
