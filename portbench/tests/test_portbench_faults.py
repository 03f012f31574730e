"""The check sees each fault a cell's timed path can have, and the
check's control: a run with the fault planted under the program (or the
control in the program's place) comes out not correct.  On the CPU at a
small batch; the faults are planted in the program's entry points the
loops call."""

import pytest

from h264_scroll_encoder_tpu_torch import session
from h264_scroll_encoder_tpu_torch.parallel import batch
from portbench_cases import BATCH_CELLS, CELLS, cpu_run

STEP_FACTORY = {"splice_rows.pooled_b1024": "make_batched_splice_step_rows",
                "scroll.b256": "make_batched_step"}


def _wrap_step(monkeypatch, cell, change):
    """Each step the cell's factory makes returns change(outputs)."""
    name = STEP_FACTORY[cell]
    make = getattr(batch, name)

    def patched(*a, **kw):
        step = make(*a, **kw)
        if name == "make_batched_step":
            def run(state, offs):
                new, out = step(state, offs)
                return change(state, new, out)
        else:
            def run(*args):
                return change(None, None, step(*args))
        return run
    monkeypatch.setattr(batch, name, patched)


def _not_correct(cell):
    result, code, lines = cpu_run(cell)
    assert code == 0
    assert not result["correct"], lines
    return result


def test_state_returned_unchanged_scroll_batch(monkeypatch):
    _wrap_step(monkeypatch, "scroll.b256",
               lambda old, new, out: (old, out))
    _not_correct("scroll.b256")


def test_state_returned_unchanged_session(monkeypatch):
    emit = session.ComposerSession._emit

    def stuck(self, fn, offset_px, **kw):
        frame_num = self.frame_num
        emit(self, fn, offset_px, **kw)
        self.frame_num = frame_num
    monkeypatch.setattr(session.ComposerSession, "_emit", stuck)
    _not_correct("scroll.session_b1")


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_half_of_the_batch_left_out(monkeypatch, cell):
    def half(old, new, out):
        nal_len = out[1].clone()
        nal_len[nal_len.shape[0] // 2:] = 0
        out = (out[0], nal_len, *out[2:])
        return out if old is None else (new, out)
    _wrap_step(monkeypatch, cell, half)
    result = _not_correct(cell)
    assert result["checks"]["frames_missing"]["value"] > 0


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_a_byte_altered_where_it_is_produced(monkeypatch, cell):
    def flip(old, new, out):
        nal = out[0].clone()
        nal[1, 40] ^= 1
        out = (nal, *out[1:])
        return out if old is None else (new, out)
    _wrap_step(monkeypatch, cell, flip)
    result = _not_correct(cell)
    assert result["checks"]["frames_missing"]["value"] == 0


def test_a_byte_altered_where_it_is_produced_session(monkeypatch):
    fetch = session._fetch

    def flip(frame):
        rows, lens, ovf = fetch(frame)
        rows = rows.copy()
        rows[0, 40] ^= 1
        return rows, lens, ovf
    monkeypatch.setattr(session, "_fetch", flip)
    _not_correct("scroll.session_b1")


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    result, code, lines = cpu_run(cell, control=True)
    assert code == 0 and not result["correct"], lines
    assert result["checks"]["frames_differing"]["value"] > 0
