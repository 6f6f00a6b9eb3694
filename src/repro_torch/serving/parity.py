"""Greedy-token parity between two engines, with bf16-tie detection.

Two correct engines can pick different greedy tokens when two logits lie
within one bf16 ULP of each other: the frameworks (or devices) sum in
other orders or round intermediate bf16 values at other places.
:class:`GreedyParity` compares the tokens of a candidate engine with a
reference step by step.  At a mismatch it reads the logits of the two
tokens — in the candidate, and in the reference when its logits are
available: if either engine holds them within one bf16 ULP it is a tie,
recorded with its margins, and that sequence is compared no further
(the two continuations now differ).  Anything else raises
``AssertionError`` with the margins.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import torch

Logits = Callable[[int], torch.Tensor]     # sid -> logits row [V]


def engine_logits(engine) -> Logits:
    """``logits(sid)`` for a :class:`~repro_torch.serving.engine.
    PagedKVEngine`: the row of its last decode step's logits."""
    return lambda sid: engine.last_logits[engine.seqs[sid].slot]


def bf16_ulp(v: float) -> float:
    """Spacing of bf16 values at magnitude ``|v|`` (8 significant bits)."""
    v = abs(v)
    if v < 2.0 ** -126:
        return 2.0 ** -133                   # bf16 subnormal spacing
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def _margin_ulps(row: torch.Tensor, a: int, b: int) -> tuple[float, float]:
    """(logit[a] - logit[b], that difference in bf16 ULPs)."""
    la, lb = float(row[a]), float(row[b])
    return la - lb, (la - lb) / bf16_ulp(max(abs(la), abs(lb)))


@dataclass
class Tie:
    sid: int
    step: int
    want: int                  # the reference engine's token
    got: int                   # the candidate engine's token
    margin: float              # candidate: logit[got] - logit[want]
    margin_ulps: float         # the same in bf16 ULPs
    ref_margin_ulps: float | None   # reference: logit[want] - logit[got]
    top2_margin: float         # candidate's top-1 minus top-2 logit


@dataclass
class GreedyParity:
    ties: list[Tie] = field(default_factory=list)
    stopped: set[int] = field(default_factory=set)
    compared: int = 0          # tokens found equal

    def check(self, step: int, want: dict[int, int], got: dict[int, int],
              logits: Logits, ref_logits: Logits | None = None) -> None:
        """``want``/``got``: {sid: token} from one decode step of the
        reference and the candidate; ``logits(sid)`` returns the
        candidate's logits row [V] for that step (for an engine:
        :func:`engine_logits`), ``ref_logits`` the reference's, if any."""
        for sid, w in want.items():
            if sid in self.stopped:
                continue
            g = got[sid]
            if g == w:
                self.compared += 1
                continue
            row = logits(sid).float().cpu()
            margin, ulps = _margin_ulps(row, g, w)
            ref_ulps = None
            if ref_logits is not None:
                ref_ulps = _margin_ulps(ref_logits(sid).float().cpu(), w,
                                        g)[1]
            top = row.topk(2).values
            tie = Tie(sid, step, w, g, margin, ulps, ref_ulps,
                      float(top[0] - top[1]))
            if abs(ulps) > 1 and (ref_ulps is None or abs(ref_ulps) > 1):
                raise AssertionError(f"greedy mismatch beyond a bf16 tie: "
                                     f"{tie}")
            self.ties.append(tie)
            self.stopped.add(sid)
