"""The model contract the serving plane schedules, plus the
deterministic ``ToyLM`` (port of ``horovod_tpu/serving/model.py``).

A :class:`ModelAdapter` sees the world in the two phases continuous
batching interleaves:

- :meth:`prefill`: the prompt's KV vectors in one shot (the
  compute-bound phase — its token count is what the scheduler's
  ``max_batch_tokens`` budget meters);
- :meth:`decode`: one token per running sequence given each sequence's
  KV context *as read back through its page table* — decode consumes
  the paged cache, so an adapter never holds per-sequence state of its
  own and preemption/re-routing cannot strand anything inside it.

``ToyLM`` keeps its parameters on a device (the GPU unless the caller
passes ``device="cpu"``) and decodes the whole running batch at once:
per-sequence context sums by one indexed add, the next tokens copied to
the host once a step. Next token and KV vectors are pure functions of
(params, context), so two hosts loaded with the same state produce
identical streams, a preempted sequence resumed by recompute continues
exactly where it left off, and a re-routed request completes with the
same tokens on the surviving worker. The oracle,
:meth:`ToyLM.reference_completion`, is numpy on the host.

Why the card's streams equal the oracle's token for token: every KV
value is an integer (``emb`` entries below 97, ``proj`` 1..kv_dim), so a
context's weighted sum is an integer. In float32 it is exact in any
summation order while ``len(context) × (96 + 16·(2+3+4)) < 2**24`` —
below about 70 000 tokens at the default ``kv_dim`` of 4. Widening
``kv_dim`` lowers that bound.
"""

import numpy as np
import torch

from .kv_cache import device_stream, resolve_device, to_device


class ModelAdapter:
    """Duck-typed contract (ToyLM is the reference implementation).

    Attributes: ``kv_dim`` (per-token KV vector width), ``eos_id``
    (generation stops early on this token; None disables), ``device``
    (where its KV vectors live; the scheduler's page pool follows it).
    """

    kv_dim = 0
    eos_id = None
    device = None

    def prefill(self, tokens):
        """``(len(tokens), kv_dim)`` KV vectors for a prompt."""
        raise NotImplementedError

    def decode(self, contexts):
        """One decode step over the running batch: ``contexts`` is a
        list of ``(n_i, kv_dim)`` KV tensors (each gathered through a
        page table); returns ``(next_tokens, next_kv)`` — a list of
        ints and one ``(kv_dim,)`` vector per sequence to append."""
        raise NotImplementedError


def toy_params(vocab=97, kv_dim=4):
    """The ToyLM parameter tree (numpy) — shaped like a real checkpoint
    (an embedding table + a projection) so the ZeRO-sharded
    ``load_for_inference`` path has something honest to transform.
    Deterministic in (vocab, kv_dim)."""
    emb = np.zeros((vocab, kv_dim), np.float32)
    emb[:, 0] = np.arange(vocab)                       # token identity
    for j in range(1, kv_dim):
        emb[:, j] = (np.arange(vocab) * (j + 3)) % 17  # mixing planes
    proj = np.arange(1, kv_dim + 1, dtype=np.float32)
    return {"emb": emb, "proj": proj}


def _host(value):
    if torch.is_tensor(value):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float32)


class ToyLM(ModelAdapter):
    """Deterministic integer LM over ``vocab`` tokens.

    KV vector of token t = ``emb[t]``; the next token is a fixed
    mixing function of the summed KV context and the context length.
    Everything routes through the page-table gather, so the KV pages
    carry the actual information decode needs. ``params`` may be numpy
    arrays or tensors (``load_for_inference``'s, on their device).
    """

    def __init__(self, params=None, vocab=97, eos_id=None, device=None):
        self.device = resolve_device(device)
        if params is None:
            params = toy_params(vocab=vocab)
        #: the oracle's copy, on the host
        self.host_params = {k: _host(v) for k, v in params.items()}
        self.params = {k: to_device(v, self.device, torch.float32)
                       for k, v in params.items()}
        self.vocab = int(self.host_params["emb"].shape[0])
        self.kv_dim = int(self.host_params["emb"].shape[1])
        self.eos_id = eos_id

    def prefill(self, tokens):
        toks = np.asarray(tokens, np.int64) % self.vocab
        with device_stream(self.device):
            return self.params["emb"].index_select(
                0, to_device(toks, self.device, torch.int64))

    def decode(self, contexts):
        """The batch's next tokens and their KV vectors: context sums
        by one indexed add over the concatenated contexts, the weighted
        sum elementwise (no matmul: TF32 would round it), and one copy
        of the tokens to the host."""
        lengths = [int(c.shape[0]) for c in contexts]
        if not lengths:
            return [], []
        with device_stream(self.device):
            flat = torch.cat([c.reshape(-1, self.kv_dim) for c in contexts])
            seq = to_device(np.repeat(np.arange(len(lengths)), lengths),
                            self.device, torch.int64)
            sums = torch.zeros(len(lengths), self.kv_dim,
                               dtype=torch.float32, device=self.device)
            sums.index_add_(0, seq, flat)
            s = (sums * self.params["proj"]).sum(dim=1)
            n = to_device(lengths, self.device, torch.int64)
            nxt = torch.remainder(torch.round(s).to(torch.int64) + 7 * n,
                                  self.vocab)
            next_kv = self.params["emb"].index_select(0, nxt)
            next_tokens = nxt.tolist()   # the step's one host sync
        return next_tokens, next_kv

    def _next(self, context):
        s = float(context.sum(axis=0) @ self.host_params["proj"]) \
            if context.shape[0] else 0.0
        return int(round(s) + 7 * context.shape[0]) % self.vocab

    def reference_completion(self, prompt, max_new_tokens):
        """The exact token stream serving must produce for ``prompt`` —
        the oracle e2e/chaos tests compare re-routed and resumed
        streams against. Runs the same prefill/decode math in numpy on
        the host, without any paging."""
        emb = self.host_params["emb"]
        ctx = emb[np.asarray(prompt, np.int64) % self.vocab]
        out = []
        for _ in range(int(max_new_tokens)):
            t = self._next(ctx)
            out.append(t)
            if self.eos_id is not None and t == self.eos_id:
                break
            ctx = np.concatenate([ctx, emb[t][None]])
        return out
