"""K5's and K6's plain versions (ops/grid) against the JAX package.

K5, composite_grid_plain: jax.vmap of the JAX package's _dense_prologue
and _bg3, plus what its rows splice reads from them (the compact_x
2-slot grid, the skip-run slots gathered at each rect row's first coded
donor MB, the last coded MB).  K6, scroll_grid_plain: the MB slots of
the JAX package's emit_p_frame symbol stream (its finish_slice replaced
by one that returns the symbols) and its tail skip run.  Seeded numpy
inputs: rects at each frame edge and inside, compact_x on and off, the
wide layout just past 4,095 MBs, P_Skip on and off, num_refs as an int
and per session, donor roles in the int8, int16 and int32 wire dtypes.
On the CPU each *_batch wrapper runs its plain version.

Tolerance: none; every output is an integer, compared element by element
in the JAX value's width (cases.jax_width).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.models import scroll as jscroll
from h264_scroll_encoder_tpu.models import splice_device as jsd
from h264_scroll_encoder_tpu.ops import bitpack as jbitpack
from h264_scroll_encoder_tpu_torch import cases
from h264_scroll_encoder_tpu_torch.ops import grid

torch.set_num_threads(1)


def _same(port, want):
    np.testing.assert_array_equal(*cases.jax_width(port, np.asarray(want)))


# ---------------------------------------------------------------------------
# K5: the composite grid.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_composite(H, W, r0, c0, R, C, compact_x):
    """The JAX package's composite stage of one session, as its rows
    splice reads it, vmapped over sessions and jitted."""
    jcfg = JaxConfig(16 * W, 16 * H)

    def one(num_refs, bg_ref, bg_mvx, bg_mvy, bg_coded, dn, first_c):
        pro = jsd._dense_prologue(jcfg, r0, c0, R, C, num_refs, bg_ref,
                                  bg_mvx, bg_mvy, bg_coded, dn)
        bg_p, bg_n = jsd._bg3(pro, H, W)
        out = {"bg_p": bg_p, "bg_n": bg_n, "sr_pat": pro["sr_pat"],
               "sr_n": pro["sr_n"], "last": pro["last_incl"][-1]}
        if compact_x:       # splice_device.rows_splice_symbols' bg2 grids
            active = pro["bg_active"]
            a2_pat, a2_n = jbitpack.merge_symbol_pairs(
                pro["a_pat"], pro["a_n"], pro["mvx_pat"], pro["mvx_n"])
            out["bg2_p"] = jnp.stack(
                [jnp.where(active, a2_pat, jnp.uint32(0)),
                 jnp.where(active, pro["c_pat"], jnp.uint32(0))],
                axis=1).reshape(H, W, 2)
            out["bg2_n"] = jnp.stack(
                [a2_n * active.astype(jnp.int32),
                 pro["c_n"] * active.astype(jnp.int32)],
                axis=1).reshape(H, W, 2)
        # The rows splice's gather: the skip run at each rect row's first
        # coded donor MB.
        idx = (r0 + jnp.arange(R, dtype=jnp.int32)) * W + c0 + jnp.maximum(
            first_c, 0)
        out["dyn_p"] = jnp.where(first_c >= 0, pro["sr_pat"][idx], 0)
        out["dyn_n"] = jnp.where(first_c >= 0, pro["sr_n"][idx], 0)
        return out

    return jax.jit(jax.vmap(one))


def _first_c(coded, R, C):
    """Each rect row's first coded donor column, -1 for none."""
    c = coded.reshape(-1, R, C)
    return np.where(c.any(axis=2), np.argmax(c, axis=2), -1).astype(np.int32)


@pytest.mark.parametrize("name", [c[0] for c in cases.COMPOSITE_GRID_CASES])
def test_composite_grid_matches_jax(name):
    rect, compact_x, nr_arg, nr, bg, dn = cases.composite_grid_case(name)
    (r0, c0, R, C), (B, H, W) = rect, bg[0].shape
    first_c = _first_c(dn["coded"], R, C)
    want = _jax_composite(H, W, r0, c0, R, C, compact_x)(
        jnp.asarray(nr), *(jnp.asarray(a) for a in bg),
        {k: jnp.asarray(v) for k, v in dn.items()}, jnp.asarray(first_c))
    args = cases.grid_args((nr_arg, *bg, dn), "cpu")
    for fn in (grid.composite_grid_plain, grid.composite_grid_batch):
        got = fn(r0, c0, R, C, *args, compact_x=compact_x)
        assert all(x.dtype == torch.int32 for x in got if x is not None)
        assert (got.bg2_p is None) == (not compact_x)
        for key in ("bg_p", "bg_n", "sr_pat", "sr_n", "last") + (
                ("bg2_p", "bg2_n") if compact_x else ()):
            _same(getattr(got, key), want[key])
        fc = torch.as_tensor(first_c)
        idx = ((r0 + torch.arange(R, dtype=torch.int32)) * W + c0
               + fc.clamp(min=0)).to(torch.int64)
        for key, src in (("dyn_p", got.sr_pat), ("dyn_n", got.sr_n)):
            _same(torch.where(fc >= 0, torch.gather(src, 1, idx), 0),
                  want[key])
    assert got.bg_p.shape == (B, H, W, 4 if H * W > 4095 else 3)


def test_composite_grid_refuses_what_jax_refuses():
    """A rect past the frame, and compact_x past 4,095 MBs (the merged
    skip-run slot), raise in both versions before any work."""
    for name, rect, compact in (("bottom_right", (6, 7, 3, 3), False),
                                ("wide", (0, 0, 6, 7), True)):
        _, _, _, _, bg, dn = cases.composite_grid_case(name)
        args = (*rect, 2, *cases.grid_args((*bg, dn), "cpu"))
        for fn in (grid.composite_grid_plain, grid.composite_grid_batch):
            with pytest.raises(ValueError):
                fn(*args, compact_x=compact)


# ---------------------------------------------------------------------------
# K6: the scroll MB grid.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_emit(h, w, enable_pskip, compact_x):
    jcfg = JaxConfig(16 * w, 16 * h)
    return jax.jit(jax.vmap(functools.partial(
        jscroll.emit_p_frame, jcfg, enable_pskip=enable_pskip,
        compact_x=compact_x, rbsp_bits_per_mb=16)))


@pytest.fixture
def jax_symbols(monkeypatch):
    """emit_p_frame's back end replaced by one returning its symbols."""
    monkeypatch.setattr(jscroll, "finish_slice",
                        lambda p, n, n_rbsp, idc, **_kw: (p, n))


@pytest.mark.parametrize("name", [c[0] for c in cases.SCROLL_GRID_CASES])
def test_scroll_grid_matches_jax(name, jax_symbols):
    pskip, compact_x, nr_arg, nr, fields = cases.scroll_grid_case(name)
    rng = np.random.default_rng(1)
    B, h, w = fields[0].shape
    n = h * w
    nh = 3
    hp = rng.integers(0, 2 ** 20, (B, nh)).astype(np.uint32)
    hn = rng.integers(1, 21, (B, nh)).astype(np.int32)
    jp, jn = _jax_emit(h, w, pskip, compact_x)(
        jnp.asarray(hp), jnp.asarray(hn),
        *(jnp.asarray(g.astype(np.int32)) for g in fields),
        jnp.asarray(nr), jnp.zeros(B, jnp.int32))
    jp, jn = np.asarray(jp), np.asarray(jn)
    S = grid.scroll_slots(n, compact_x)
    assert jp.shape[1] == nh + n * S + 1
    # The JAX stream's last coded MB: every coded MB has nonzero width.
    live = (jn[:, nh:nh + n * S].reshape(B, n, S) != 0).any(axis=2)
    want_last = np.where(live.any(axis=1),
                         n - 1 - np.argmax(live[:, ::-1], axis=1), -1)
    for fn in (grid.scroll_grid_plain, grid.scroll_grid_batch):
        mb_p, mb_n, last = fn(*cases.grid_args((*fields, nr_arg), "cpu"),
                              enable_pskip=pskip, compact_x=compact_x)
        assert mb_p.dtype == mb_n.dtype == last.dtype == torch.int32
        assert mb_p.shape == (B, n, S)
        _same(mb_p, jp[:, nh:nh + n * S].reshape(B, n, S))
        _same(mb_n, jn[:, nh:nh + n * S].reshape(B, n, S))
        np.testing.assert_array_equal(last.numpy(), want_last)
    if pskip:
        assert not live.all(), "no MB was skipped: the case tests nothing"


# ---------------------------------------------------------------------------
# What the wrappers hand the kernels (csrc/grid_device.cuh's Field).
# ---------------------------------------------------------------------------

def test_field_descriptors():
    """Each tensor goes to the kernels in place as (address, batch, row
    and column strides in bytes, dtype code); num_refs as a value, or as
    a tensor of 1 or B values with a batch stride in bytes."""
    x = torch.zeros((4, 6, 10), dtype=torch.int16)[:, 1:5, ::2]
    assert grid._field(x) == (x.data_ptr(), 120, 20, 4, 2)
    assert grid._field(torch.zeros((2, 3, 3), dtype=torch.bool))[1:] == (
        9, 3, 1, -1)
    assert grid._field(torch.zeros((2, 1, 3), dtype=torch.int8))[4] == 1
    with pytest.raises(TypeError):
        grid._field(torch.zeros((2, 3, 3)))
    assert grid._num_refs_field(5, 4, "cpu")[1:] == ((0, 0, 0, 0, 4), 5)
    for nr, stride in ((torch.tensor(3), 0),
                       (torch.arange(4, dtype=torch.int64), 8),
                       (torch.arange(4, dtype=torch.int32)[:, None], 4)):
        t, f, v = grid._num_refs_field(nr, 4, "cpu")
        assert f == (t.data_ptr(), stride, 0, 0, t.element_size()) and v == 0
    with pytest.raises(ValueError):
        grid._num_refs_field(torch.arange(3), 4, "cpu")
    d = grid._descriptors([(1, 2, 3, 4, 5), (6, 7, 8, 9, -1)])
    assert list(d) == [1, 2, 3, 4, 5, 6, 7, 8, 9, -1]
