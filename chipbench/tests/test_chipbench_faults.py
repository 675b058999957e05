"""The checks see a broken timed path: the rest of a run is driven on the
CPU at a tiny width with one fault planted underneath, and ``correct``
comes out false, once for each fault the cell can have.  (No cell spans
chips, so no exchange between chips can be left out.)"""
import itertools

import pytest
import torch

from .tiny import SERVE, TRAIN, run_tiny, tiny_cell


def unchanged_train_step(monkeypatch):
    """The compiled train step returns its state unchanged."""
    from repro_torch.train import train_step as ts

    def call(self, state, batch):
        for k, v in batch.items():
            self.batch[k].copy_(v)
        metrics = self._step_fn(self.state, self.batch)[1]
        self.metrics = {k: v.clone() for k, v in metrics.items()}
        return self.state, self.metrics
    monkeypatch.setattr(ts.TrainGraph, "__call__", call)


#: steps of the tiny training cell's set-up (``setup_cycles`` x
#: ``save_every``)
TINY_SETUP_STEPS = 4


def unchanged_window_step(monkeypatch):
    """The steps of the window, beside the save bodies in flight, return
    their state unchanged; the set-up's steps are sound."""
    from repro_torch.train import train_step as ts
    real = ts.TrainGraph.__call__
    calls = itertools.count()

    def call(self, state, batch):
        if next(calls) < TINY_SETUP_STEPS:
            return real(self, state, batch)
        for k, v in batch.items():
            self.batch[k].copy_(v)
        metrics = self._step_fn(self.state, self.batch)[1]
        self.metrics = {k: v.clone() for k, v in metrics.items()}
        return self.state, self.metrics
    monkeypatch.setattr(ts.TrainGraph, "__call__", call)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from repro_torch.train import train_step as ts
    real = ts.compile_train_step

    def compile_half(step_fn, state, example, **kw):
        def halved(st, batch):
            return step_fn(st, {k: v[:v.shape[0] // 2]
                                for k, v in batch.items()})
        return real(halved, state, example, **kw)
    monkeypatch.setattr(ts, "compile_train_step", compile_half)


def altered_token(monkeypatch):
    """The token a decode step produces is another: the best logit is
    pushed below every other."""
    from repro_torch.train import serve_step as ss
    real = ss.DecodeGraph.__call__

    def call(self, tokens):
        logits, cache = real(self, tokens)
        best = logits.argmax(-1)
        rows = torch.arange(logits.shape[0])
        logits[rows, best] = logits.min() - 1
        return logits, cache
    monkeypatch.setattr(ss.DecodeGraph, "__call__", call)


def one_slot_scaled(monkeypatch):
    """One slot of the batch gets logits a quarter too large: its
    tokens stay the same, every position of its requests is off."""
    from repro_torch.train import serve_step as ss
    real = ss.DecodeGraph.__call__

    def call(self, tokens):
        logits, cache = real(self, tokens)
        logits[1] *= 1.25
        return logits, cache
    monkeypatch.setattr(ss.DecodeGraph, "__call__", call)


def unchanged_decode_step(monkeypatch):
    """The decode step returns the session's cache unchanged: it runs on
    a copy and drops it."""
    from repro_torch.train import serve_step as ss
    from repro_torch.train.tree import tree_map

    def call(self, tokens):
        self.tokens.copy_(tokens)
        logits, _ = self._m.decode_step(self._params,
                                        tree_map(torch.clone, self.cache),
                                        self.tokens, self._cfg)
        return logits, self.cache
    monkeypatch.setattr(ss.DecodeGraph, "__call__", call)


@pytest.mark.parametrize("cell,fault", [
    (TRAIN, unchanged_train_step), (TRAIN, unchanged_window_step),
    (TRAIN, half_batch), (SERVE, altered_token), (SERVE, one_slot_scaled),
    (SERVE, unchanged_decode_step)],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_planted_fault_comes_out_not_correct(tiny_root, monkeypatch, cell,
                                               fault):
    c = tiny_cell(tiny_root, cell)
    fault(monkeypatch)
    out = run_tiny(c, seconds=1.0)
    assert out["correct"] is False, out["checks"]
