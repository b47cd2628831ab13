"""Faults a serving cell can have, planted in the program's calls after
the engine is made (`run_cell(..., hook=FAULTS[name])`): each breaks the
timed path underneath, and a run with it has to come out not correct.

- `decode_state_unchanged`: a decode step returns its cache and `pos` as
  they were before it (what it wrote is lost);
- `prefill_state_unchanged`: a prefill's cache is never written (its
  rows and state stay zero);
- `half_batch_left_out`: a decode step computes half of the batch and
  hands the other half the first half's logits;
- `token_altered`: the token a request is served is not the one its
  logits put first.

The exchange between chips does not exist on a one-card cell.
"""
from __future__ import annotations


def decode_state_unchanged(engine, model):
    step = model.decode_step

    def decode_step(cache, tokens):
        kept = {k: v.clone() for k, v in cache.items()}
        logits, new = step(cache, tokens)
        for k, v in kept.items():
            if k != "pos":
                new[k].copy_(v)
        new["pos"] = kept["pos"]
        return logits, new
    model.decode_step = decode_step


def prefill_state_unchanged(engine, model):
    prefill = model.prefill

    def unwritten(tokens, max_len=None):
        logits, cache = prefill(tokens, max_len=max_len)
        for k, v in cache.items():
            if k != "pos":
                v.zero_()
        return logits, cache
    model.prefill = unwritten


def half_batch_left_out(engine, model):
    step = model.decode_step

    def decode_step(cache, tokens):
        logits, new = step(cache, tokens)
        half = logits.shape[0] // 2
        logits[half:2 * half] = logits[:half].clone()
        return logits, new
    model.decode_step = decode_step


def token_altered(engine, model):
    select = engine._select_token
    vocab = model.cfg.vocab_size

    def altered(logits_row):
        return (select(logits_row) + 1) % vocab
    engine._select_token = altered


FAULTS = {"decode_state_unchanged": decode_state_unchanged,
          "prefill_state_unchanged": prefill_state_unchanged,
          "half_batch_left_out": half_batch_left_out,
          "token_altered": token_altered}
