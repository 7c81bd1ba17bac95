"""How ``correct`` is decided: the served tokens of a sample of finished
requests against the plain float32 reference.

Once the window has closed, the peak memory is read and the engine is
freed, a sample of the finished requests is drawn from the seed, the
longest by served tokens always among them.  The reference runs once over
each prompt followed by its served tokens (the last one never fed back)
and gives the logits after every position that produced a served token.
A served token's gap is how far its logit lies below the reference's best
there, in logit units: 0 where the program and the reference agree on the
argmax, small where rounding flips a near tie, large where the program
computed something else.  Over the sample each run reads the widest gap,
the mean gap, the worst request's mean gap and the share of served tokens
that are not the reference's first choice; a cell compares those that
``portbench/checks/<cell>.json`` names, each with its limit.

The control (``control=True``, never in the benchmark's own runs) reads
the same numbers at the same positions of the same sequences for the
tokens that the reference computed with float8 operands puts first, and
:func:`control_verdict` scores them, in the program's place, against the
cell's own limits: a sound check finds the control not correct.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Tuple

import torch

from portbench.reference import family

from .serving import Rec, Run


def sample(run: Run, seed: int, n: int) -> List[Rec]:
    """``n`` finished requests (the open loop's due ones; the closed
    batch's finished in the window), the longest by served tokens first,
    the rest drawn from the seed."""
    done = [r for r in run.recs if r.finish_t is not None
            and r.finish_t <= run.t_drained and r.generated]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.generated), r.req.idx))
    rest = done[1:]
    rng = random.Random(int(seed) * 7919 + 17)
    return [done[0]] + rng.sample(rest, min(n - 1, len(rest)))


def _sequence(rec: Rec, device) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    p = rec.req.prompt
    toks = torch.tensor(p + rec.generated[:-1], device=device)
    rows = torch.arange(len(p) - 1, len(p) - 1 + len(rec.generated),
                        device=device)
    return toks, rows, torch.tensor(rec.generated, device=device)


NUMBERS = ("logit_gap", "mean_gap", "worst_mean_gap", "not_first")


def summary(parts: List[torch.Tensor]) -> Dict[str, float]:
    """The numbers a check may compare, from each request's token gaps."""
    g = torch.cat(parts).float()
    return {"logit_gap": float(g.max()), "mean_gap": float(g.mean()),
            "worst_mean_gap": max(float(p.float().mean()) for p in parts),
            "not_first": float((g > 0).float().mean())}


def gaps(cfg: Dict[str, Any], weights: Dict[str, Any], recs: List[Rec],
         device, control: bool = False) -> Dict[str, Any]:
    """The served tokens' numbers over ``recs`` (``served_<number>``); with
    ``control``, the same of the float8 reference's first choices
    (``control_<number>``).  ``random_token_gap`` is the mean gap a token
    drawn at random would have: what one wrong token adds to a sum of
    gaps."""
    ref = family(cfg)
    served: List[torch.Tensor] = []
    low: List[torch.Tensor] = []
    random_gap = 0.0
    for rec in recs:
        toks, rows, tok = _sequence(rec, device)
        logits = ref.logits_at(weights, cfg, toks, rows)
        best = logits.max(-1).values
        served.append(best - logits.gather(1, tok[:, None])[:, 0])
        random_gap += float((best - logits.mean(-1)).sum())
        if control:
            pick = ref.logits_at(weights, cfg, toks, rows,
                                 quant="fp8").argmax(-1)
            low.append(best - logits.gather(1, pick[:, None])[:, 0])
        del logits
    tokens = sum(len(p) for p in served)
    out: Dict[str, Any] = {"requests": len(recs), "tokens": tokens,
                           "random_token_gap": random_gap / max(tokens, 1)}
    values = summary(served) if served else dict.fromkeys(NUMBERS, 0.0)
    out.update({f"served_{k}": v for k, v in values.items()})
    if low:
        out.update({f"control_{k}": v for k, v in summary(low).items()})
    return out


def verdict(values: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """Each number beside its limit (a number passes at or below it)."""
    table = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in table.values()), table


def control_verdict(readings: Dict[str, Any], limits: Dict[str, float]
                    ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """The verdict on the control's numbers put in the program's place."""
    return verdict({k: readings[k.replace("served_", "control_", 1)]
                    for k in limits}, limits)


def limits_of(check: Dict[str, Any]) -> Dict[str, float]:
    return {k: v["limit"] for k, v in check.items()
            if isinstance(v, dict) and "limit" in v}


def n_sample(check: Dict[str, Any]) -> int:
    return int(check["sample_requests"])


def collect(eng, recs: List[Rec]) -> None:
    """Copy each request's served tokens out of the engine, so the engine
    can be freed before the reference runs."""
    for r in recs:
        if r.rid is not None and r.rid in eng.requests:
            r.generated = list(eng.requests[r.rid].generated)
