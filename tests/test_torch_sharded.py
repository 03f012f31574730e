"""Port vs JAX: the sharded step (parallel/batch.make_sharded_step over a
device list) against the JAX package's make_sharded_step on the 8-device
virtual CPU mesh, the split/gather helpers, egress across shards and the
multi-device dry run.  Seeded inputs; tolerance: exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from h264_scroll_encoder_tpu.config import ComposerConfig as JaxConfig
from h264_scroll_encoder_tpu.parallel import batch as jbatch
from h264_scroll_encoder_tpu_torch.config import ComposerConfig
from h264_scroll_encoder_tpu_torch.parallel import batch, dryrun

torch.set_num_threads(1)

# tests/test_batch.py's configuration: tall, crosses the 496 px waypoint
# limit; offsets repeat after a waypoint step.
CFG = (64, 1024)
OFFSETS = [0, 100, 496, 496, 600, 992, 992, 1000, 300, 12]
FIELDS = ("frame_num", "wp_offsets", "wp_ltidx", "wp_valid", "wp_count")
N_JAX = 8                       # the conftest's virtual mesh
B = 2 * N_JAX


def _schedule():
    """[10, B]: session b walks OFFSETS shifted by b steps, plus a seeded
    jitter of whole MB rows, so blocks differ in their waypoint steps."""
    rng = np.random.default_rng(16)
    t = np.arange(len(OFFSETS))[:, None] + np.arange(B)[None, :]
    base = np.asarray(OFFSETS)[t % len(OFFSETS)]
    return (base + 16 * rng.integers(0, 2, (1, B))).astype(np.int32)


def _jax_sharded_run(sched):
    mesh = Mesh(np.array(jax.devices()[:N_JAX]), axis_names=("sessions",))
    sharding = NamedSharding(mesh, P("sessions"))
    step = jbatch.make_sharded_step(JaxConfig(*CFG), mesh)
    state = jax.tree.map(lambda x: jax.device_put(x, sharding),
                         jbatch.SessionState.create(B))
    outs = []
    for offs in sched:
        state, out = step(state, jax.device_put(jnp.asarray(offs), sharding))
        outs.append(tuple(np.asarray(x) for x in out))
    return state, outs


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_step_equals_jax_sharded_step(n_devices):
    """make_sharded_step over ["cpu"] * n equals the JAX package's
    make_sharded_step on the 8-device mesh, every output and the final
    state, step by step."""
    assert len(jax.devices()) >= N_JAX
    sched = _schedule()
    jstate, jouts = _jax_sharded_run(sched)
    devices = ["cpu"] * n_devices
    step = batch.make_sharded_step(ComposerConfig(*CFG), devices)
    states = batch.shard_batch(batch.SessionState.create(B, device="cpu"),
                               devices)
    waypoints = 0
    for offs, jout in zip(sched, jouts):
        states, outs = step(states, batch.shard_batch(offs, devices))
        assert len(outs) == n_devices
        assert all(o[0].shape[0] == B // n_devices for o in outs)
        for got, want in zip(batch.gather_batch(outs), jout):
            np.testing.assert_array_equal(got.numpy(), want)
        waypoints += int(jout[2].sum())
    final = batch.gather_batch(states)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(final, f).numpy(),
                                      np.asarray(getattr(jstate, f)))
    assert waypoints >= B          # every session registered a waypoint


def test_sharded_step_equals_unsharded_with_options():
    """enable_pskip and the waypoint-free step shard too."""
    sched = _schedule()[:4]
    devices = ["cpu"] * 4
    for kw in ({"enable_pskip": True}, {"emit_waypoints": False}):
        cfg = ComposerConfig(*CFG)
        ustep = batch.make_batched_step(cfg, **kw)
        sstep = batch.make_sharded_step(cfg, devices, **kw)
        u = batch.SessionState.create(B, device="cpu")
        s = batch.shard_batch(u, devices)
        for offs in sched:
            u, uout = ustep(u, torch.as_tensor(offs))
            s, souts = sstep(s, batch.shard_batch(offs, devices))
            for a, b in zip(uout, batch.gather_batch(souts)):
                assert torch.equal(a, b)


def test_batch_that_does_not_divide_raises():
    state = batch.SessionState.create(6, device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        batch.shard_batch(state, ["cpu"] * 4)
    with pytest.raises(ValueError, match="does not split"):
        batch.shard_batch(torch.zeros(5), ["cpu"] * 2)
    # As a NamedSharding refuses it in the JAX package.
    mesh = Mesh(np.array(jax.devices()[:4]), axis_names=("sessions",))
    with pytest.raises(ValueError):
        jax.device_put(jnp.zeros(6), NamedSharding(mesh, P("sessions")))
    step = batch.make_sharded_step(ComposerConfig(*CFG), ["cpu"] * 4)
    blocks = batch.shard_batch(batch.SessionState.create(8, device="cpu"),
                               ["cpu"] * 2)
    with pytest.raises(ValueError, match="blocks for 4 devices"):
        step(blocks, batch.shard_batch(torch.zeros(8, dtype=torch.int32),
                                       ["cpu"] * 2))


def test_shard_and_gather_round_trip():
    rng = np.random.default_rng(2)
    state = batch.SessionState.from_numpy({
        "frame_num": rng.integers(0, 99, 8).astype(np.int32),
        "wp_offsets": rng.integers(0, 9999, (8, 8)).astype(np.int32),
        "wp_ltidx": rng.integers(2, 10, (8, 8)).astype(np.int32),
        "wp_valid": rng.random((8, 8)) < 0.5,
        "wp_count": rng.integers(0, 8, 8).astype(np.int32)}, device="cpu")
    blocks = batch.shard_batch(state, ["cpu"] * 4)
    assert [b.frame_num.tolist() for b in blocks] == [
        state.frame_num[i:i + 2].tolist() for i in range(0, 8, 2)]
    back = batch.gather_batch(blocks)
    for f in FIELDS:
        assert torch.equal(getattr(back, f), getattr(state, f))
        assert getattr(back, f).dtype == getattr(state, f).dtype

    dn = {"blob": torch.as_tensor(rng.integers(0, 2**32, (8, 37))),
          "first_c": torch.as_tensor(rng.integers(-1, 5, (8, 4)),
                                     dtype=torch.int32)}
    blocks = batch.shard_batch(dn, ["cpu"] * 2)
    assert [set(b) for b in blocks] == [set(dn)] * 2
    assert all(b["blob"].shape == (4, 37) for b in blocks)
    back = batch.gather_batch(blocks)
    assert all(torch.equal(back[k], dn[k]) for k in dn)
    # numpy input, tuples (a step's outputs) and a target device
    pair = (rng.integers(0, 9, (8, 3)), np.arange(8))
    back = batch.gather_batch(batch.shard_batch(pair, ["cpu"] * 8), "cpu")
    assert all(np.array_equal(b.numpy(), p) for b, p in zip(back, pair))


def test_run_on_blocks_runs_every_block_in_order():
    """run_on_blocks calls the step once per block with the i-th entry of
    each block list; the rows step run so equals the unsharded step."""
    assert batch.run_on_blocks(lambda a, b: (a, b), ["cpu"] * 3,
                               [1, 2, 3], "xyz") == [(1, "x"), (2, "y"),
                                                     (3, "z")]
    cfg = ComposerConfig(64, 64)
    rng = np.random.default_rng(4)
    devices = ["cpu"] * 2
    sd = dryrun.splice_device
    dr = sd.pack_donor_rows(sd.prepare_donor_dense(
        dryrun.fixtures.representative_donor_grid(rng, 2, 2), 2), 2, 2)
    dn = {k: dryrun._bcast(v, 4)
          for k, v in sd.rows_device_arrays(dr, "cpu").items()}
    args = (dryrun._header(cfg, 4, "cpu") + dryrun._background(cfg, 4, "cpu")
            + (dn,))
    step = batch.make_batched_splice_step_rows(cfg, 1, 1, 2, 2,
                                               has_align=dr.has_align)
    want = step(*args)
    assert not want[3].any() and want[1].min() > 0
    got = batch.gather_batch(batch.run_on_blocks(
        step, devices, *(batch.shard_batch(a, devices) for a in args)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n_devices", [1, 2, 3])
def test_egress_across_shards_equals_compact_batch_nal(n_devices):
    """compact_sharded_nal over the blocks equals compact_batch_nal (the
    port's and the JAX package's) on the whole batch: packed bytes, total
    and overflow, for caps above, at, just below and far below the
    total."""
    rng = np.random.default_rng(9 + n_devices)
    nal = rng.integers(1, 256, (12, 70)).astype(np.uint8)
    lens = rng.integers(0, 71, 12).astype(np.int32)
    lens[[1, 5]] = 0
    devices = ["cpu"] * n_devices
    nb = batch.shard_batch(nal, devices)
    lb = batch.shard_batch(lens, devices)
    total = int(lens.sum())
    for cap in (total + 40, total, total - 1, 64, 1):
        got = batch.compact_sharded_nal(nb, lb, cap)
        want = batch.compact_batch_nal(torch.as_tensor(nal),
                                       torch.as_tensor(lens), cap)
        jwant = jbatch.compact_batch_nal(jnp.asarray(nal), jnp.asarray(lens),
                                         cap)
        for g, w, j in zip(got, want, jwant):
            assert g.dtype == w.dtype and torch.equal(g, w)
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
        assert bool(got[2]) == (cap < total)


def test_egress_ring_on_sharded_steps():
    """Per step, the sharded step's NALs compacted across the blocks equal
    the unsharded step's compacted NALs."""
    cfg = ComposerConfig(64, 64)
    devices = ["cpu"] * 4
    ustep = batch.make_batched_step(cfg, emit_waypoints=False)
    sstep = batch.make_sharded_step(cfg, devices, emit_waypoints=False)
    u = batch.SessionState.create(8, device="cpu")
    s = batch.shard_batch(u, devices)
    for t in range(3):
        offs = torch.as_tensor((np.arange(8) * 4 + 8 * t) % 64,
                               dtype=torch.int32)
        u, (nal, nal_len, *_rest) = ustep(u, offs)
        s, outs = sstep(s, batch.shard_batch(offs, devices))
        want = batch.compact_batch_nal(nal, nal_len, 8 * 2048)
        got = batch.compact_sharded_nal([o[0] for o in outs],
                                        [o[1] for o in outs], 8 * 2048)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert not got[2] and int(got[1]) == int(nal_len.sum())


@pytest.mark.parametrize("n_devices", [2, 4])
def test_dryrun_multigpu_on_cpu(n_devices):
    report = dryrun.dryrun_multigpu(["cpu"] * n_devices)
    assert report["64x64 scroll step"] == 2 * n_devices
    assert report["720p scroll step"] == report["720p hint step"] == n_devices
    assert set(report) == {
        "64x64 scroll step", "dense splice step", "rows compact splice step",
        "rows static-chrome splice step", "successive-donor rows step",
        "720p scroll step", "720p hint step", "run_frames", "egress ring",
        "fresh-donor rows step"}


def test_dryrun_catches_a_wrong_shard(monkeypatch):
    """The dry run's comparisons have teeth: egress across shards that
    drops one byte fails it."""
    real = batch.compact_sharded_nal

    def off_by_one(*args, **kw):
        packed, total, ovf = real(*args, **kw)
        packed = packed.clone()
        packed[0] ^= 1
        return packed, total, ovf

    monkeypatch.setattr(batch, "compact_sharded_nal", off_by_one)
    with pytest.raises(AssertionError, match="egress ring"):
        dryrun.dryrun_multigpu(["cpu"] * 2)


def test_dryrun_cli_on_cpu(capsys):
    assert dryrun.main(["--device", "cpu", "--device", "cpu"]) == 0
    assert "sharded == unsharded" in capsys.readouterr().out
