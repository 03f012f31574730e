"""The port's widths against the JAX package's, and the int64 share of the
serving steps' bytes.

The JAX package runs without jax_enable_x64, so its symbol stages compute
in 32 bits: int32 values, uint32 patterns and words.  The port keeps those
widths (ops/expgolomb's rule): jnp.int32 is torch.int32, jnp.uint32 is
torch.int32 holding the same bits, bool and uint8 stay.  Each function of
the slice gets the same seeded numpy inputs in both packages; its outputs
must have the mapped dtypes and equal values (uint32 against the port's
bits viewed as uint32, cases.jax_width).  Where the JAX package has no
function for a symbol stage on its own (the frames hand their symbols to
finish_slice or _finish_splice), that back end is replaced by one that
returns the symbols.

The guard runs the rows compact, dense, scroll and hint steps and one
session frame op by op under scripts/step_cost's Census (each aten op's
tensor arguments read once and results written once) and fails where
int64 is more than 15% of a step's bytes, naming the largest int64
producers.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.models import hints as jhints
from h264_scroll_encoder_tpu.models import scroll as jscroll
from h264_scroll_encoder_tpu.models import splice_device as jsd
from h264_scroll_encoder_tpu.ops import bitpack as jbitpack
from h264_scroll_encoder_tpu.ops import expgolomb as jeg
from h264_scroll_encoder_tpu.syntax import slice_headers as jheaders
from h264_scroll_encoder_tpu_torch import cases, session
from h264_scroll_encoder_tpu_torch.config import ComposerConfig, MAX_WAYPOINTS
from h264_scroll_encoder_tpu_torch.models import hints, scroll
from h264_scroll_encoder_tpu_torch.models import mb_transcode as mbt
from h264_scroll_encoder_tpu_torch.models import splice_device as sd
from h264_scroll_encoder_tpu_torch.ops import bitpack_flat, expgolomb
from h264_scroll_encoder_tpu_torch.ops.bitio import BitWriter
from h264_scroll_encoder_tpu_torch.parallel import batch
from h264_scroll_encoder_tpu_torch.scripts.step_cost import Census
from h264_scroll_encoder_tpu_torch.syntax import slice_headers
from h264_scroll_encoder_tpu_torch.utils import fixtures

torch.set_num_threads(1)

# The most of a serving step's aten bytes that int64 may take: index
# arguments and local unsigned widenings, not the symbol stage.
INT64_SHARE_MAX = 0.15
SMALL = (320, 240)                  # 20 x 15 MBs
RECT = (4, 3, 5, 6)                 # c0, r0, R, C
TALL = (64, 1024)                   # crosses the 496 px waypoint limit


def _same(port, want):
    """Equal values in the JAX value's width (cases.jax_width)."""
    np.testing.assert_array_equal(*cases.jax_width(port, want))


def _i32(a):
    """Seeded numpy values as the port takes them: int32 (bits)."""
    return torch.as_tensor(cases.int32_bits(a))


def _registry(rng, B, height):
    """Waypoint registries and offsets (numpy int32 and bool)."""
    count = rng.integers(0, MAX_WAYPOINTS + 1, B)
    slot = np.arange(MAX_WAYPOINTS)[None, :]
    valid = (slot < count[:, None]) & (rng.random((B, MAX_WAYPOINTS)) < 0.9)
    st = dict(frame_num=rng.integers(0, 40, B),
              offsets=rng.integers(0, height + 1, B),
              wp_offsets=(slot + 1) * 496 * (slot < count[:, None]),
              wp_ltidx=(2 + slot) * (slot < count[:, None]), wp_count=count)
    st = {k: v.astype(np.int32) for k, v in st.items()}
    st["wp_valid"] = valid
    return st


_ORDER = ("frame_num", "offsets", "wp_offsets", "wp_ltidx", "wp_valid",
          "wp_count")


def _jax_state(st):
    return tuple(jnp.asarray(st[k]) for k in _ORDER)


def _port_state(st):
    return tuple(torch.as_tensor(st[k]) for k in _ORDER)


@pytest.fixture
def jax_symbols(monkeypatch):
    """The JAX frames' symbols: finish_slice and _finish_splice replaced
    by back ends that return (patterns, nbits, nal_ref_idc)."""
    def stub(patterns, nbits, n_rbsp, nal_ref_idc=0, **_kw):
        return patterns, nbits, jnp.asarray(nal_ref_idc, jnp.int32)

    monkeypatch.setattr(jscroll, "finish_slice", stub)
    monkeypatch.setattr(jsd, "_finish_splice", stub)


# ---------------------------------------------------------------------------
# Exp-Golomb, headers, K2/K4's plain versions.
# ---------------------------------------------------------------------------

def test_expgolomb_widths():
    rng = np.random.default_rng(0)
    u = np.concatenate([[0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1],
                        rng.integers(0, 2 ** 32, 200, dtype=np.uint64)])
    s = np.concatenate([[0, 1, -1, 2 ** 31 - 1, -2 ** 31],
                        rng.integers(-2 ** 31, 2 ** 31, 200)])
    ju, js = jnp.asarray(u.astype(np.uint32)), jnp.asarray(s.astype(np.int32))
    for got, want in ((expgolomb.ue(_i32(u)), jeg.ue(ju)),
                      (expgolomb.se(_i32(s)), jeg.se(js)),
                      ((expgolomb.se_mapped(_i32(s)),), (jeg.se_mapped(js),)),
                      ((expgolomb.ue_bit_length(_i32(u)),),
                       (jeg.ue_bit_length(ju),)),
                      ((expgolomb._ilog2(_i32(u[1:])),),
                       (jeg._ilog2(ju[1:]),))):
        for g, w in zip(got, want):
            _same(g, w)
    num = np.asarray([1, 2, 3, 9], np.int32)
    v = rng.integers(0, 12, (4, 30))
    got = expgolomb.te(_i32(v), _i32(num)[:, None])
    want = jax.vmap(jeg.te)(jnp.asarray(v.astype(np.uint32)), jnp.asarray(num))
    for g, w in zip(got, want):
        _same(g, w)


def test_slice_header_widths():
    rng = np.random.default_rng(1)
    B = 6
    st = _registry(rng, B, 1024)
    is_ref = rng.random(B) < 0.5
    lt = np.where(rng.random(B) < 0.5, -1, rng.integers(0, 10, B)).astype(np.int32)
    prev = rng.integers(0, 4, B).astype(np.int32)
    jp, jn = jax.jit(jax.vmap(functools.partial(
        jheaders.p_slice_header_symbols, JaxConfig(64, 64))))(
        jnp.asarray(st["frame_num"]), jnp.asarray(st["frame_num"] * 2),
        jnp.asarray(is_ref), jnp.asarray(lt), jnp.asarray(st["wp_count"]),
        jnp.asarray(st["wp_ltidx"]), jnp.asarray(st["wp_valid"]),
        prev_ref_abs_diff=jnp.asarray(prev))
    tp, tn = slice_headers.p_slice_header_symbols(
        ComposerConfig(64, 64), torch.as_tensor(st["frame_num"]),
        torch.as_tensor(st["frame_num"] * 2), torch.as_tensor(is_ref),
        torch.as_tensor(lt), torch.as_tensor(st["wp_count"]),
        torch.as_tensor(st["wp_ltidx"]), torch.as_tensor(st["wp_valid"]),
        prev_ref_abs_diff=torch.as_tensor(prev))
    _same(tp, jp)
    _same(tn, jn)


@pytest.mark.parametrize("entry", ["place_plain", "place", "words",
                                   "split_plain"])
def test_pack_widths(entry):
    """K2 and K4 (their plain versions on CPU tensors) and the cluster
    plan's model: the JAX package's uint32 words and int32 totals."""
    pat, nb = cases.pack_cases(7, 3, 300, 80)
    fn = {"place_plain": bitpack_flat.pack_words_place_plain,
          "place": bitpack_flat.pack_words_place_batch,
          "words": bitpack_flat.pack_words_batch,
          "split_plain": functools.partial(bitpack_flat.pack_words_split_plain,
                                           parts=3)}[entry]
    words, total = fn(_i32(pat), torch.as_tensor(nb), 80)
    jw, jt = jax.vmap(lambda p, n: jbitpack.pack_words(p, n, 80))(
        jnp.asarray(pat), jnp.asarray(nb))
    _same(words, jw)
    _same(total, jt)


# ---------------------------------------------------------------------------
# The scroll and hint symbol stages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", ["generic", "compact_pskip"])
def test_p_frame_symbol_widths(form, jax_symbols):
    rng = np.random.default_rng(2)
    B, h, w = 3, 6, 10
    compact = pskip = form == "compact_pskip"
    jcfg, cfg = JaxConfig(16 * w, 16 * h), ComposerConfig(16 * w, 16 * h)
    ref = rng.integers(0, 2, (B, h, w)).astype(np.int32)
    mvx = (np.zeros((B, h, w)) if compact
           else rng.integers(-8, 9, (B, h, w)) * 4).astype(np.int32)
    mvy = (rng.integers(-8, 9, (B, h, w)) * 4).astype(np.int32)
    still = rng.random((B, h, w)) < 0.4
    ref[still], mvx[still], mvy[still] = 0, 0, 0
    st = _registry(rng, B, 16 * h)
    hp, hn = jax.vmap(functools.partial(
        jheaders.p_slice_header_symbols, jcfg, is_reference=False,
        long_term_idx=-1))(jnp.asarray(st["frame_num"]),
                           jnp.asarray(st["frame_num"] * 2),
                           num_waypoints=jnp.asarray(st["wp_count"]),
                           wp_long_term_idx=jnp.asarray(st["wp_ltidx"]),
                           wp_valid=jnp.asarray(st["wp_valid"]))
    num_refs = (2 + st["wp_count"]).astype(np.int32)
    kw = dict(enable_pskip=pskip, compact_x=compact, rbsp_bits_per_mb=16)
    jp, jn, _ = jax.jit(jax.vmap(functools.partial(jscroll.emit_p_frame, jcfg,
                                                **kw)))(
        hp, hn, jnp.asarray(ref), jnp.asarray(mvx), jnp.asarray(mvy),
        jnp.asarray(num_refs), jnp.zeros(B, jnp.int32))
    tp, tn, _ = scroll.p_frame_symbols(
        cfg, _i32(np.asarray(hp)), torch.as_tensor(np.array(hn)),
        torch.as_tensor(ref), torch.as_tensor(mvx), torch.as_tensor(mvy),
        torch.as_tensor(num_refs), **kw)
    _same(tp, jp)
    _same(tn, jn)


@pytest.mark.parametrize("policy", ["floor", "partitioned"])
def test_unified_frame_symbol_widths(policy, jax_symbols):
    """unified_frame_symbols (the scroll step's stage) and, for
    "partitioned", partitioned_frame_symbols inside it."""
    rng = np.random.default_rng(3)
    B = 5
    st = _registry(rng, B, TALL[1])
    is_wp = rng.random(B) < 0.5
    jp, jn, jidc = jax.jit(jax.vmap(functools.partial(
        jscroll.unified_frame, JaxConfig(*TALL), boundary_policy=policy)))(
        *_jax_state(st), jnp.asarray(is_wp))
    tp, tn, _, tidc = scroll.unified_frame_symbols(
        ComposerConfig(*TALL), *_port_state(st), torch.as_tensor(is_wp),
        boundary_policy=policy)
    for g, w in ((tp, jp), (tn, jn), (tidc, jidc)):
        _same(g, w)


def test_sliced_frame_symbol_widths(jax_symbols):
    rng = np.random.default_rng(4)
    B, rows = 3, 4
    st = _registry(rng, B, 576)
    jp, jn, _ = jax.jit(jax.vmap(functools.partial(
        jscroll.scroll_frame_sliced, JaxConfig(96, 576),
        rows_per_slice=rows)))(*_jax_state(st))
    tp, tn, _ = scroll.sliced_frame_symbols(
        ComposerConfig(96, 576), *_port_state(st), rows_per_slice=rows)
    _same(tp, jp.reshape(tp.shape))
    _same(tn, jn.reshape(tn.shape))


def test_hint_symbol_widths(jax_symbols, monkeypatch):
    """hint_frame's symbols: the port's back end replaced as the JAX
    package's is."""
    rng = np.random.default_rng(5)
    B = 3
    cfg, jcfg = ComposerConfig(*SMALL), JaxConfig(*SMALL)
    inputs = cases.hint_step_inputs(B)
    H, W = cfg.mb_height, cfg.mb_width
    ref = np.zeros((B, H, W), np.int32)
    mvy = np.zeros((B, H, W), np.int32)
    ref[:, 2:9, 3:12] = rng.integers(0, 2, (B, 1, 1))
    mvy[:, 2:9, 3:12] = (rng.integers(-8, 9, (B, 1, 1)) * 4)
    inputs.update(ref=ref, mv_x=np.zeros_like(ref), mv_y=mvy)
    order = ("frame_num", "ref", "mv_x", "mv_y", "wp_count", "wp_ltidx",
             "wp_valid")
    fn = jhints._jitted_hint_frame.__wrapped__(jcfg, True)
    jp, jn, _ = jax.vmap(fn)(*(jnp.asarray(inputs[k]) for k in order))
    monkeypatch.setattr(scroll, "finish_slice",
                        lambda p, n, n_rbsp, idc, **_kw: (p, n))
    tp, tn = hints.hint_frame(cfg, *(torch.as_tensor(inputs[k])
                                     for k in ("frame_num", "ref", "mv_x",
                                               "mv_y", "wp_count", "wp_ltidx",
                                               "wp_valid")))
    _same(tp, jp)
    _same(tn, jn)


# ---------------------------------------------------------------------------
# The splice symbol stages and the donor wire.
# ---------------------------------------------------------------------------

def _donor_payload(seed, kind="representative"):
    c0, r0, R, C = RECT
    rng = np.random.default_rng(seed)
    grid = (fixtures.representative_donor_grid(rng, C, R) if kind != "ipcm"
            else fixtures.random_p_slice_grid(rng, C, R, 1))
    if kind == "ipcm":
        grid[0][0] = fixtures.random_ipcm_mb(rng, in_p_slice=True)
    bw = BitWriter()
    mbt.emit_p_slice_mbs(bw, grid, 1)
    bw.write_trailing_bits()
    return bw.getvalue()


def _donors(kind, seeds):
    """[(port DonorDense, JAX DonorDense)] of the payloads (Python engines)."""
    c0, r0, R, C = RECT
    out = []
    for s in seeds:
        pay = _donor_payload(s, kind)
        out.append((sd.prepare_donor_dense_from_slice(pay, 0, C, R, 1, 2,
                                                      engine="python"),
                    jsd.prepare_donor_dense_from_slice(pay, 0, C, R, 1, 2,
                                                       engine="python")))
    return out


def _headers(B):
    jcfg, cfg = JaxConfig(*SMALL), ComposerConfig(*SMALL)
    jhp, jhn = jheaders.p_slice_header_symbols(
        jcfg, jnp.int32(3), jnp.int32(6), is_reference=False, long_term_idx=-1,
        num_waypoints=jnp.int32(0),
        wp_long_term_idx=jnp.zeros(MAX_WAYPOINTS, jnp.int32),
        wp_valid=jnp.zeros(MAX_WAYPOINTS, bool))
    hp, hn = slice_headers.p_slice_header_symbols(
        cfg, torch.full((B,), 3, dtype=torch.int32), 6, False, -1, 0,
        torch.zeros((B, MAX_WAYPOINTS), dtype=torch.int32),
        torch.zeros((B, MAX_WAYPOINTS), dtype=torch.bool))
    return (hp, hn), (jhp, jhn)


def _background(B):
    H, W = ComposerConfig(*SMALL).mb_height, ComposerConfig(*SMALL).mb_width
    rng = np.random.default_rng(6)
    bg_ref = np.zeros((H, W), np.int32)
    bg_mvy = np.zeros((H, W), np.int32)
    bg_coded = np.zeros((H, W), bool)
    bg_ref[1:9], bg_mvy[1:9], bg_coded[1:9] = 1, 4 * int(rng.integers(1, 9)), True
    bg = (bg_ref, np.zeros((H, W), np.int32), bg_mvy, bg_coded)
    return (tuple(torch.as_tensor(a).expand((B,) + a.shape) for a in bg),
            tuple(jnp.asarray(a) for a in bg))


def _stack(dicts):
    return {k: np.stack([np.asarray(d[k]) for d in dicts]) for k in dicts[0]}


@pytest.mark.parametrize("compact_x", [False, True])
def test_rows_splice_symbol_widths(compact_x):
    """rows_splice_symbols over the JAX package's rows wire, carried
    across by donor_arrays_from_numpy."""
    c0, r0, R, C = RECT
    pairs = _donors("representative", (11, 12))
    jdrs = [jsd.pack_donor_rows(j, R, C, min_class=32) for _, j in pairs]
    wire = _stack([jsd.rows_device_arrays(d) for d in jdrs])
    (hp, hn), (jhp, jhn) = _headers(len(pairs))
    pbg, jbg = _background(len(pairs))
    kw = dict(n_rbsp=4096, compact_x=compact_x)
    jp, jn = jax.jit(jax.vmap(
        lambda dn: jsd.rows_splice_symbols(JaxConfig(*SMALL), c0, r0, R, C, 2,
                                           jhp, jhn, *jbg, dn, **kw)[:2]))(
        {k: jnp.asarray(v) for k, v in wire.items()})
    tp, tn, _ = sd.rows_splice_symbols(
        ComposerConfig(*SMALL), c0, r0, R, C, 2, hp, hn, *pbg,
        sd.donor_arrays_from_numpy(wire, "cpu"), **kw)
    _same(tp, jp)
    _same(tn, jn)


def test_dense_splice_symbol_widths(jax_symbols):
    c0, r0, R, C = RECT
    pairs = _donors("ipcm", (21, 22))
    wire = cases.stack_dense([j for _, j in pairs])
    (hp, hn), (jhp, jhn) = _headers(len(pairs))
    pbg, jbg = _background(len(pairs))
    jp, jn, _ = jax.jit(jax.vmap(
        lambda dn: jsd.emit_spliced_frame_dense(
            JaxConfig(*SMALL), c0, r0, R, C, 2, jhp, jhn, *jbg, dn,
            has_align=True, n_rbsp=8192)))(
        {k: jnp.asarray(v) for k, v in wire.items()})
    tp, tn, _ = sd.dense_splice_symbols(
        ComposerConfig(*SMALL), c0, r0, R, C, 2, hp, hn, *pbg,
        sd.donor_arrays_from_numpy(wire, "cpu"), n_rbsp=8192)
    _same(tp, jp)
    _same(tn, jn)


def test_donor_wire_widths():
    """donor_arrays_from_numpy carries each JAX wire across in its widths:
    uint32 as an int32 view of the same bits, the rest as they are."""
    c0, r0, R, C = RECT
    pairs = _donors("ipcm", (31,))
    jdr = jsd.pack_donor_rows(pairs[0][1], R, C)
    host = {k: np.asarray(v)[None] for k, v in jsd.rows_device_arrays(jdr).items()}
    fw, s_flat, s_exc = jsd.rows_flat_wire(host.pop("row_patterns"),
                                           host.pop("row_nbits"))
    blob = jsd.pack_rows_blob({**host, **fw}, R, C, s_flat, s_exc)
    for wire in (jsd.rows_device_arrays(jdr), jsd.dense_device_arrays(pairs[0][1]),
                 {"blob": blob}):
        got = sd.donor_arrays_from_numpy({k: np.asarray(v)
                                          for k, v in wire.items()}, "cpu")
        assert set(got) == set(wire)
        for k, v in wire.items():
            _same(got[k], v)
    assert got["blob"].dtype == torch.int32
    unblob = sd._unblob(got["blob"], R, C, s_flat, s_exc)
    want = jax.vmap(lambda b: jsd._unblob(b, R, C, s_flat, s_exc))(
        jnp.asarray(blob))
    for k, v in want.items():
        _same(unblob[k], v)


# ---------------------------------------------------------------------------
# The guard: the int64 share of each serving step's bytes.
# ---------------------------------------------------------------------------

def _rows_step(B):
    cfg = ComposerConfig(*SMALL)
    c0, r0, R, C = RECT
    pays = [_donor_payload(40 + k) for k in range(2)]
    dn, (bits, align) = sd.prepare_donor_rows_serving(
        pays, [0, 0], R, C, 1, 2, s_row=64, blob_wire=True, s_flat=384,
        s_exc=16, engine="python", device="cpu")
    step = batch.make_batched_splice_step_rows(
        cfg, c0, r0, C, R, 2, has_align=bool(align.any()), compact_x=True,
        n_rbsp=sd.splice_rbsp_budget(cfg, R * C, int(bits.max())), s_row=64,
        s_flat=384, s_exc=16)
    (hp, hn), _ = _headers(B)
    bg, _ = _background(B)
    return step.eager, (hp, hn, *bg, {"blob": dn["blob"][torch.arange(B) % 2]})


def _dense_step(B):
    cfg = ComposerConfig(*SMALL)
    c0, r0, R, C = RECT
    dds = [d for d, _ in _donors("ipcm", (51, 52))]
    dn = sd.donor_arrays_from_numpy(cases.stack_dense(dds), "cpu")
    step = batch.make_batched_splice_step_dense(cfg, c0, r0, C, R, 2,
                                                has_align=True)
    (hp, hn), _ = _headers(B)
    bg, _ = _background(B)
    return step.eager, (hp, hn, *bg,
                        {k: v[torch.arange(B) % 2] for k, v in dn.items()})


def _scroll_step(B):
    cfg = ComposerConfig(*TALL)
    state = batch.SessionState.create(B, device="cpu")
    offs = torch.as_tensor(cases.bench_schedule(TALL[1], B, 1)[0])
    return batch.make_batched_step(cfg).eager, (state, offs)


def _hint_step(B):
    cfg = ComposerConfig(*SMALL)
    inputs = cases.hint_step_inputs(B)
    H, W = cfg.mb_height, cfg.mb_width
    ref = np.zeros((B, H, W), np.int32)
    mvy = np.zeros((B, H, W), np.int32)
    mvy[:, 3:11, :] = 8
    inputs.update(ref=ref, mv_x=np.zeros_like(ref), mv_y=mvy)
    step = batch.make_batched_hint_step(cfg, compact_x=True, device="cpu")
    return step.eager, tuple(torch.as_tensor(inputs[k]) for k in (
        "frame_num", "ref", "mv_x", "mv_y", "wp_count", "wp_ltidx",
        "wp_valid"))


def _session_frame(_B):
    cfg = ComposerConfig(*TALL)
    row = np.zeros(session.FRAME_ROW, np.int32)
    row[0], row[1] = 5, 300
    return (session.graphed_frame("scroll_frame", cfg, False).eager,
            (torch.as_tensor(row),))


@pytest.mark.parametrize("name,make", [("rows compact", _rows_step),
                                       ("dense", _dense_step),
                                       ("scroll", _scroll_step),
                                       ("hint", _hint_step),
                                       ("session frame", _session_frame)])
def test_int64_share_of_step_bytes(name, make):
    step, args = make(4)
    census = Census()
    with census:
        step(*args)
    share = census.int64_share()
    assert census.total > 0
    assert share <= INT64_SHARE_MAX, (
        f"{name}: int64 is {share:.1%} of {census.total} aten bytes "
        f"(at most {INT64_SHARE_MAX:.0%}); the largest int64 producers: "
        + ", ".join(f"{op} {b} B" for op, b in census.top_int64()))
