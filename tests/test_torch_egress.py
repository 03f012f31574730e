"""Egress compaction on the CPU: the plain version (K8's contract,
parallel/batch.compact_batch_nal_plain) over the sweep of
cases.COMPACT_CASES against the sessions' bytes concatenated in numpy,
K8's launch arguments and the errors it raises before any launch, its
tile plan, and proof that CPU tensors never load the kernel library.
Imports no jax (the JAX package's differential tests of the plain
version are in test_torch_hints.py and, over the sweep,
test_torch_egress_jax.py).  Tolerance: exact equality (bytes
and integers)."""

import numpy as np
import pytest
import torch

from h264_scroll_encoder_tpu_torch import _kernels, cases
from h264_scroll_encoder_tpu_torch.parallel import batch

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(cases.COMPACT_CASES))
def test_compact_plain_sweep(name):
    """Every case of the sweep at every cap: packed, total and overflow as
    numpy concatenates the rows, through the dispatcher and the plain
    version alike."""
    case = cases.compact_case(name)
    nal, lens = cases.compact_tensors(case, "cpu")
    for cap in case["caps"]:
        packed, total, ovf = cases.compact_reference(case["nal"],
                                                     case["nal_len"], cap)
        for fn in (batch.compact_batch_nal, batch.compact_batch_nal_plain):
            got = fn(nal, lens, cap)
            assert got[0].dtype == torch.uint8 and got[0].shape == (cap,)
            assert got[0].numpy().tobytes() == packed
            assert got[1].dtype == torch.int32 and got[1].dim() == 0
            assert int(got[1]) == total == case["total"]
            assert got[2].dtype == torch.bool and bool(got[2]) == ovf


def test_compact_sweep_covers_the_edges():
    """The sweep has B = 1, 7, 256, 1,024 and 4,096, widths not a multiple
    of 4, all-zero batches, int32 and int64 lengths, strided rows and
    lengths, sessions at every offset mod 16 from rows at every address
    mod 16, and caps above, at, one below and far below the total."""
    shapes = {n: cases.compact_case(n) for n in cases.COMPACT_CASES}
    assert {c["nal"].shape[0] for c in shapes.values()} >= {1, 7, 256, 1024,
                                                            4096}
    assert any(c["nal"].shape[1] % 4 for c in shapes.values())
    assert any(c["total"] == 0 and c["nal"].shape[0] > 1
               for c in shapes.values())
    assert {c["nal_len"].dtype for c in shapes.values()} == {
        np.dtype(np.int32), np.dtype(np.int64)}
    assert any(c["nal"].strides[0] != c["nal"].shape[1]
               for c in shapes.values())
    assert any(c["nal_len"].strides[0] != c["nal_len"].itemsize
               for c in shapes.values())
    c = shapes["every_alignment"]
    starts = np.concatenate([[0], np.cumsum(c["nal_len"])[:-1]])
    assert set(starts % 16) == set(range(16))
    assert set(np.arange(c["nal"].shape[0]) * c["nal"].strides[0] % 16) == set(
        range(16))
    for c in shapes.values():
        t = c["total"]
        assert {t, t // 3} <= set(c["caps"]) and max(c["caps"]) > t
        assert t == 0 or t - 1 in c["caps"]


def _bad_inputs():
    nal = torch.zeros((8, 40), dtype=torch.uint8)
    lens = torch.full((8,), 5, dtype=torch.int32)
    wide = torch.zeros((8, 80), dtype=torch.uint8)
    return [
        ("nal float", TypeError, (nal.float(), lens, 64)),
        ("nal int32", TypeError, (nal.int(), lens, 64)),
        ("lengths int16", TypeError, (nal, lens.short(), 64)),
        ("lengths float", TypeError, (nal, lens.float(), 64)),
        ("lengths a list", TypeError, (nal, lens.tolist(), 64)),
        ("nal numpy", TypeError, (nal.numpy(), lens, 64)),
        ("cap a float", TypeError, (nal, lens, 64.0)),
        ("nal 1-D", ValueError, (nal[0], lens[:1], 64)),
        ("nal 3-D", ValueError, (nal[None], lens, 64)),
        ("no rows", ValueError, (nal[:0], lens[:0], 64)),
        ("lengths short", ValueError, (nal, lens[:4], 64)),
        ("lengths 2-D", ValueError, (nal, lens[:, None], 64)),
        ("lengths 0-dim", ValueError, (nal[:1], lens[0], 64)),
        ("columns strided", ValueError, (wide[:, ::2], lens, 64)),
        ("cap negative", ValueError, (nal, lens, -1)),
        ("cap past int32", ValueError, (nal, lens, 1 << 31)),
        ("lengths on another device", ValueError,
         (nal, lens.to("meta"), 64)),
        ("rows past int32", ValueError,
         (torch.zeros(1, dtype=torch.uint8).expand(1 << 16, 1 << 15),
          torch.zeros(1 << 16, dtype=torch.int32), 64)),
    ]


@pytest.mark.parametrize("label,err,args", _bad_inputs(),
                         ids=[b[0] for b in _bad_inputs()])
def test_compact_kernel_refuses_what_it_cannot_read(label, err, args):
    """K8's launch arguments raise before any launch for what the kernel
    cannot read in place: a dtype, shape or stride of another kind, inputs
    on two devices, a cap outside [0, 2**31), rows whose lengths could sum
    past int32."""
    with pytest.raises(err):
        batch.compact_nal_args(*args)


def test_compact_kernel_arguments_read_inputs_in_place():
    """The launch arguments of strided rows and lengths: the tensors'
    addresses, the row stride and the lengths' stride in their own units,
    the lengths' width, B and the cap; a numpy integer cap is taken."""
    case = cases.compact_case("strided_lengths")
    nal, lens = cases.compact_tensors(case, "cpu")
    got = batch.compact_nal_args(nal, lens, np.int64(100))
    assert got == (nal.data_ptr(), 80, 64, lens.data_ptr(), 2, 8, 257, 100)
    nal32, lens32 = cases.compact_tensors(cases.compact_case("strided_rows"),
                                          "cpu")
    assert batch.compact_nal_args(nal32, lens32, 7)[1:] == (
        251, 123, lens32.data_ptr(), 1, 4, 300, 7)


@pytest.mark.parametrize("cap,sms,tile", [
    (10_518_528, 132, 16_384),    # the pooled splice cell: 642 blocks
    (1_877_248, 132, 4_096),      # the scroll cell: 459 blocks
    (1_877_248, 16, 16_384),
    (300_000, 132, 4_096),
    (0, 132, 4_096),
    (1, 1, 4_096),
    (4 * 132 * 16_384, 132, 16_384),
    (527 * 16_384, 132, 8_192),
])
def test_compact_tile_plan(cap, sms, tile):
    """The tile a block writes: 4,096 bytes times 4, 2 or 1, the largest
    that leaves at least four blocks an SM (4,096 where none does)."""
    assert batch.compact_tile(cap, sms) == tile
    assert tile % (16 * 256) == 0


def test_compact_on_cpu_tensors_never_loads_the_kernel_library(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_kernels, "_load", refuse)
    monkeypatch.setattr(_kernels.COMPACT_NAL, "launch", refuse)
    before = _kernels.COMPACT_NAL.launches
    for name in ("b7_ragged", "strided_lengths", "b4096_tiny"):
        case = cases.compact_case(name)
        nal, lens = cases.compact_tensors(case, "cpu")
        for cap in case["caps"]:
            got = batch.compact_batch_nal(nal, lens, cap)
            assert got[0].numpy().tobytes() == cases.compact_reference(
                case["nal"], case["nal_len"], cap)[0]
        got = batch.compact_sharded_nal([nal[:3], nal[3:]],
                                        [lens[:3], lens[3:]], 64)
        assert int(got[1]) == case["total"]
    assert _kernels.COMPACT_NAL.launches == before
    assert _kernels.COMPACT_NAL in _kernels.KERNELS
    assert _kernels.launch_counts()["h264t_compact_nal"] == before
