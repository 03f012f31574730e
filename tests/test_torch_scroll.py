"""Port vs JAX: slice headers, field assignment, MV-prediction stencils
and P-frame emission (models/scroll).  Seeded numpy inputs; the JAX
functions run per session under vmap (staged back end on the CPU).
Tolerance: exact equality (integers and bytes)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.models import scroll as jscroll
from h264_scroll_encoder_tpu.syntax import slice_headers as jheaders
from h264_scroll_encoder_tpu_torch.config import ComposerConfig, MAX_WAYPOINTS
from h264_scroll_encoder_tpu_torch.models import scroll
from h264_scroll_encoder_tpu_torch.syntax import slice_headers

torch.set_num_threads(1)

CFG = (64, 1024)        # tall: crosses the 496 px waypoint limit


def _t(a):
    """Inputs in the JAX package's widths (int32)."""
    return torch.as_tensor(np.asarray(a).astype(np.int32))


def _eq(port, want):
    np.testing.assert_array_equal(port.numpy().astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def _registry(rng, B, height):
    """Random waypoint registries plus offsets: count in 0..8, offsets of
    valid slots at multiples of 496, some invalid slots."""
    count = rng.integers(0, MAX_WAYPOINTS + 1, B)
    slot = np.arange(MAX_WAYPOINTS)[None, :]
    offsets = (slot + 1) * 496 * (slot < count[:, None])
    valid = (slot < count[:, None]) & (rng.random((B, MAX_WAYPOINTS)) < 0.9)
    ltidx = (2 + slot) * (slot < count[:, None])
    offs = rng.integers(0, height + 1, B)
    offs[: B // 3] = 496 * rng.integers(0, 3, B // 3)     # exact waypoints
    frame_num = rng.integers(0, 40, B)
    return dict(frame_num=frame_num, offsets=offs, wp_offsets=offsets,
                wp_ltidx=ltidx, wp_valid=valid, wp_count=count)


def _j(st, key, dtype=np.int32):
    return jnp.asarray(st[key].astype(dtype))


@pytest.mark.parametrize("poc_type,deblock", [(2, 1), (0, 0)])
def test_p_slice_header_symbols(poc_type, deblock):
    rng = np.random.default_rng(poc_type)
    B = 12
    st = _registry(rng, B, 1024)
    is_ref = rng.random(B) < 0.5
    lt_idx = np.where(rng.random(B) < 0.5, -1, rng.integers(0, 10, B))
    first_mb = rng.integers(0, 500, B)
    prev = rng.integers(0, 4, B)
    jcfg = JaxConfig(64, 64, pic_order_cnt_type=poc_type,
                     deblocking_filter_control_present_flag=deblock)
    tcfg = ComposerConfig(64, 64, pic_order_cnt_type=poc_type,
                          deblocking_filter_control_present_flag=deblock)
    for qp in (0, 3, -2):
        jf = jax.vmap(functools.partial(jheaders.p_slice_header_symbols, jcfg,
                                        slice_qp_delta=qp))
        jp, jn = jf(_j(st, "frame_num"), _j(st, "frame_num") * 2,
                    jnp.asarray(is_ref), jnp.asarray(lt_idx.astype(np.int32)),
                    _j(st, "wp_count"), _j(st, "wp_ltidx"),
                    jnp.asarray(st["wp_valid"]),
                    jnp.asarray(first_mb.astype(np.int32)),
                    prev_ref_abs_diff=jnp.asarray(prev.astype(np.int32)))
        tp, tn = slice_headers.p_slice_header_symbols(
            tcfg, _t(st["frame_num"]), _t(st["frame_num"]) * 2,
            torch.as_tensor(is_ref), _t(lt_idx), _t(st["wp_count"]),
            _t(st["wp_ltidx"]), torch.as_tensor(st["wp_valid"]),
            first_mb=_t(first_mb), slice_qp_delta=qp,
            prev_ref_abs_diff=_t(prev))
        assert tp.shape == (B, slice_headers.P_HEADER_SLOTS)
        _eq(tp, jp)
        _eq(tn, jn)


def test_field_assignment_and_waypoint_checks():
    rng = np.random.default_rng(1)
    B = 40
    st = _registry(rng, B, 1024)
    jcfg, tcfg = JaxConfig(*CFG), ComposerConfig(*CFG)
    is_wp = rng.random(B) < 0.5
    for policy in ("floor", "nearest"):
        jf = jax.vmap(functools.partial(jscroll.mb_fields_traced, jcfg,
                                        boundary_policy=policy))
        jr, jm = jf(_j(st, "offsets"), _j(st, "wp_offsets"),
                    jnp.asarray(st["wp_valid"]), _j(st, "wp_count"),
                    jnp.asarray(is_wp))
        tr, tm = scroll.mb_fields_traced(
            tcfg, _t(st["offsets"]), _t(st["wp_offsets"]),
            torch.as_tensor(st["wp_valid"]), _t(st["wp_count"]),
            torch.as_tensor(is_wp), boundary_policy=policy)
        _eq(tr, jr)
        _eq(tm, jm)
    jneeds = jax.vmap(jscroll.needs_waypoint)(
        _j(st, "offsets"), _j(st, "wp_offsets"), jnp.asarray(st["wp_valid"]),
        _j(st, "wp_count"))
    tneeds = scroll.needs_waypoint(_t(st["offsets"]), _t(st["wp_offsets"]),
                                   torch.as_tensor(st["wp_valid"]),
                                   _t(st["wp_count"]))
    _eq(tneeds, jneeds)
    assert tneeds.any() and (~tneeds).any()
    # The partitioned seam has no per-MB field grid (its seam row carries
    # two partitions): both packages reject it here, as any unknown policy.
    for policy in ("partitioned", "ceil"):
        with pytest.raises(ValueError, match="boundary_policy"):
            scroll.mb_fields(tcfg, _t(st["offsets"]), _t(st["wp_offsets"]),
                             torch.as_tensor(st["wp_valid"]),
                             _t(st["wp_count"]), is_waypoint_frame=False,
                             boundary_policy=policy)
        with pytest.raises(ValueError, match="boundary_policy"):
            jscroll.mb_fields(jcfg, jnp.int32(7), _j(st, "wp_offsets")[0],
                              jnp.asarray(st["wp_valid"][0]), jnp.int32(0),
                              is_waypoint_frame=False, boundary_policy=policy)


def _grids(rng, B, h, w, zero_x=False):
    ref = rng.integers(0, 4, (B, h, w))
    mv_x = np.zeros((B, h, w), np.int64) if zero_x else \
        rng.integers(-12, 13, (B, h, w)) * 4
    mv_y = rng.integers(-12, 13, (B, h, w)) * 4
    # Patches of zero motion on ref 0 so P_Skip cases occur.
    still = rng.random((B, h, w)) < 0.3
    ref[still] = 0
    mv_x[still] = 0
    mv_y[still] = 0
    return ref, mv_x, mv_y


def test_prediction_stencils():
    rng = np.random.default_rng(2)
    B, h, w = 5, 7, 9
    ref, mvx, mvy = _grids(rng, B, h, w)
    J = [jnp.asarray(a.astype(np.int32)) for a in (ref, mvx, mvy)]
    T = [_t(a) for a in (ref, mvx, mvy)]
    for jf, tf in ((jscroll.mv_pred_grid, scroll.mv_pred_grid),
                   (jscroll.pskip_mv_grid, scroll.pskip_mv_grid)):
        jx, jy = jax.vmap(jf)(*J)
        tx, ty = tf(*T)
        _eq(tx, jx)
        _eq(ty, jy)
    for jn, tn in zip(jax.vmap(jscroll._neighbors)(J[1]),
                      scroll._neighbors(T[1])):
        _eq(tn, jn)
    roles = [rng.integers(-8, 9, (B, h, w)) for _ in range(9)]
    cur = rng.integers(0, 4, (B, h, w))
    jx, jy = jax.vmap(jscroll.mv_pred_grid_roles)(
        jnp.asarray(cur.astype(np.int32)),
        *[jnp.asarray(a.astype(np.int32)) for a in roles])
    tx, ty = scroll.mv_pred_grid_roles(_t(cur), *[_t(a) for a in roles])
    _eq(tx, jx)
    _eq(ty, jy)


@pytest.mark.parametrize("form", ["generic", "compact_x", "pskip",
                                  "pskip_compact", "wide", "exact"])
def test_emit_p_frame(form):
    rng = np.random.default_rng(["generic", "compact_x", "pskip",
                                 "pskip_compact", "wide", "exact"].index(form))
    h, w = (260, 16) if form == "wide" else (6, 10)   # wide: 4,160 MBs
    B = 2 if form == "wide" else 4
    jcfg, tcfg = JaxConfig(16 * w, 16 * h), ComposerConfig(16 * w, 16 * h)
    compact = form in ("compact_x", "pskip_compact", "wide")
    pskip = form.startswith("pskip")
    exact = form == "exact"
    ref, mvx, mvy = _grids(rng, B, h, w, zero_x=compact)
    st = _registry(rng, B, 16 * h)
    num_refs = 2 + st["wp_count"]
    ref = np.minimum(ref, num_refs[:, None, None] - 1)
    idc = rng.integers(0, 3, B)
    hp, hn = jax.vmap(functools.partial(
        jheaders.p_slice_header_symbols, jcfg, is_reference=False,
        long_term_idx=-1))(_j(st, "frame_num"), _j(st, "frame_num") * 2,
                           num_waypoints=_j(st, "wp_count"),
                           wp_long_term_idx=_j(st, "wp_ltidx"),
                           wp_valid=jnp.asarray(st["wp_valid"]))
    kw = dict(enable_pskip=pskip, ebsp_exact=exact, compact_x=compact,
              rbsp_bits_per_mb=0 if exact else 16)
    want = jax.jit(jax.vmap(functools.partial(jscroll.emit_p_frame, jcfg,
                                              **kw)))(
        hp, hn, *[jnp.asarray(a.astype(np.int32)) for a in (ref, mvx, mvy)],
        jnp.asarray(num_refs.astype(np.int32)),
        jnp.asarray(idc.astype(np.int32)))
    got = scroll.emit_p_frame(tcfg, _t(hp), _t(hn), _t(ref), _t(mvx), _t(mvy),
                              _t(num_refs), _t(idc), **kw)
    ovf = got[3].numpy()
    np.testing.assert_array_equal(ovf, np.asarray(want[3]))
    assert not ovf.all()
    for g, wnt in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy()[~ovf].astype(np.int64),
                                      np.asarray(wnt)[~ovf].astype(np.int64))


@pytest.mark.parametrize("waypoint", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_scroll_and_waypoint_frames(waypoint, exact):
    rng = np.random.default_rng(10 + 2 * waypoint + exact)
    B = 6
    st = _registry(rng, B, 1024)
    jcfg, tcfg = JaxConfig(*CFG), ComposerConfig(*CFG)
    jf = jscroll.waypoint_frame if waypoint else jscroll.scroll_frame
    tf = scroll.waypoint_frame if waypoint else scroll.scroll_frame
    want = jax.jit(jax.vmap(functools.partial(jf, jcfg, ebsp_exact=exact)))(
        _j(st, "frame_num"), _j(st, "offsets"), _j(st, "wp_offsets"),
        _j(st, "wp_ltidx"), jnp.asarray(st["wp_valid"]), _j(st, "wp_count"))
    got = tf(tcfg, _t(st["frame_num"]), _t(st["offsets"]),
             _t(st["wp_offsets"]), _t(st["wp_ltidx"]),
             torch.as_tensor(st["wp_valid"]), _t(st["wp_count"]),
             ebsp_exact=exact)
    assert not np.asarray(want[3]).any()
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(wnt).astype(np.int64))
