"""Batched serving engine: continuous-batching LM decode over a shared KV
cache.

The engine keeps a fixed slot pool (the batch dimension). A request takes
a free slot, its prompt is fed token by token through the decode step into
that slot's cache lines, and each ``tick`` advances every live slot by one
token in one decode step; requests join and leave between ticks. Greedy
sampling keeps it deterministic.

Each slot keeps its own length: the decode step writes K/V only into the
slots it steps, at their own positions, and masks each slot by its own
length (``models/transformer.py``). So a request gets the tokens it would
get alone. The reference's engine steps every slot at one shared length and
mixes concurrent requests (fault R5); with one live request the two agree.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.param import cast_floats, tree_map


@dataclass
class Request:
    prompt: np.ndarray  # [P] int32
    max_new: int
    out: list = field(default_factory=list)
    slot: int = -1  # a free slot named here is taken; else the engine picks
    pos: int = 0
    done: bool = False


class LMEngine:
    """``params`` are cast once to the config's activation type and held on
    ``device`` (None = CUDA)."""

    def __init__(self, cfg: tfm.LMConfig, params, n_slots: int, max_len: int,
                 device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = cast_floats(tree_map(lambda t: t.to(self.device), params),
                                  cfg.act_dtype)
        self.n_slots = n_slots
        self.max_len = max_len
        self.cache = tfm.init_kv_cache(cfg, n_slots, max_len, self.device)
        self._decode = tfm.make_decode_step(cfg)
        self._free = list(range(n_slots))
        self._live: dict[int, Request] = {}
        self._pos = np.zeros(n_slots, np.int32)  # each slot's length

    def submit(self, req: Request) -> bool:
        if not self._free:
            return False
        if req.slot in self._free:
            self._free.remove(req.slot)
        else:
            req.slot = self._free.pop()
        # Feed all but the last prompt token (the first tick feeds it, and
        # its logits give the first generated token).
        for t in req.prompt[:-1]:
            self._step({req.slot: int(t)})
        req.pos = len(req.prompt) - 1
        self._live[req.slot] = req
        return True

    def _step(self, tokens: dict[int, int]) -> dict[int, int]:
        """One decode step of the slots in ``tokens`` (slot → token); the
        others are neither written nor read. Returns slot → next token."""
        slots = sorted(tokens)
        toks = torch.zeros((self.n_slots, 1), dtype=torch.int32)
        active = torch.zeros(self.n_slots, dtype=torch.bool)
        toks[slots, 0] = torch.tensor([tokens[s] for s in slots], dtype=torch.int32)
        active[slots] = True
        dev = self.device
        logits, self.cache = self._decode(
            self.params, self.cache,
            {"tokens": toks.to(dev), "cur_len": torch.as_tensor(self._pos).to(dev),
             "active": active.to(dev)},
        )
        self._pos[slots] += 1
        nxt = torch.argmax(logits[slots, 0, : self.cfg.vocab], dim=-1).tolist()
        return dict(zip(slots, nxt))

    def tick(self) -> list[Request]:
        """Advance every live request one token; return completions."""
        if not self._live:
            return []
        nxt = self._step({slot: int(req.prompt[-1] if not req.out else req.out[-1])
                          for slot, req in self._live.items()})
        finished = []
        for slot, req in list(self._live.items()):
            req.out.append(nxt[slot])
            if len(req.out) >= req.max_new:
                req.done = True
                finished.append(req)
                del self._live[slot]
                self._free.append(slot)
                self._pos[slot] = 0
                # zero the slot's cache lines for the next tenant
                for c in self.cache.values():
                    c[:, slot] = 0
        return finished

    @property
    def n_live(self) -> int:
        return len(self._live)
