"""The comparison that decides ``correct``.

Once the window has closed, every request sent must have been answered
with as many tokens as it asked for.  Then a sample drawn from the seed of
the requests the remote tier answered, the longest among them, is run
through the plain reference with the tokens it was served, and each served
token is scored by its gap: how far its reference logit lies below the
reference's best at that position.  Every request the hedge tier answered
is scored the same way against the hedge model.  A configuration holds
the remote tier's widest gap, or, where the widest does not part the
program from its control (an expert stack, whose bf16 routing flips a
near-tied expert choice now and then, and one flip sets the widest gap),
the share of its scored tokens that lie more than the configuration's
``far_gap`` below the reference's best, and the hedge tier's widest gap,
each to a limit of its own.

What a request's answer is: the answer to its own prompt, as the
reference computes it for that prompt alone.  The serving loop batches the
requests of a tick that chose the same tier, right-pads their prompts with
token 0 to the longest of them, adds all-zero rows up to a power of two,
and decodes as many steps as the longest answer asks for, attending over
the padding; so today a shorter row's answer is the answer to its padded
batch, which differs.  Until the program masks its padding, each request
is also read as its batch asked it (the batch rebuilt from which requests
shared a dispatch, the tier's dispatch stamp, by that rule), and it is
scored by the nearer of the two readings: the one whose widest gap is
smaller.  A request alone in its batch reads the same both ways.  A dense
stack's rows do not interact, so each sampled row runs by itself; an
expert stack's rows share capacity, so its sampled batches run whole, step
by step, feeding each served token and, where no served token exists
(padding rows, rows the hedge answered, steps past a row's answer), the
reference's own best token.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference.model import Reference


@dataclasses.dataclass
class Served:
    """One request as the benchmark saw it."""

    rid: int
    prompt: np.ndarray
    n_steps: int
    tokens: Optional[np.ndarray]  # served tokens, None if never answered
    used_remote: Optional[bool]
    remote_batch: Optional[float]  # the remote tier's dispatch stamp
    hedge_batch: Optional[float]


@dataclasses.dataclass
class Batch:
    rows: List[Served]  # in dispatch order
    width: int
    n_rows: int  # rows padded to a power of two
    steps: int


def batches(served: Sequence[Served], key: str) -> Dict[float, Batch]:
    groups: Dict[float, List[Served]] = {}
    for s in served:
        k = getattr(s, key)
        if k is not None:
            groups.setdefault(k, []).append(s)
    out = {}
    for k, rows in groups.items():
        rows = sorted(rows, key=lambda s: s.rid)
        n = len(rows)
        out[k] = Batch(rows=rows, width=max(len(s.prompt) for s in rows),
                       n_rows=1 << (n - 1).bit_length(), steps=max(s.n_steps for s in rows))
    return out


def _gaps(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Per position: best logit less the served token's."""
    return logits.max(-1).values - logits.gather(-1, tokens[:, None])[:, 0]


def _nearer(a: List[np.ndarray], b: List[Optional[np.ndarray]]):
    """Per request, the reading (alone or as padded) whose widest gap is
    smaller; how many took the padded one."""
    out, padded = [], 0
    for x, y in zip(a, b):
        if y is not None and x.size and y.max() < x.max():
            out.append(y)
            padded += 1
        else:
            out.append(x)
    return out, padded


def _alone(s: Served, b: Batch) -> bool:
    """Whether the batch asked ``s`` exactly what its prompt alone asks."""
    return b.width == len(s.prompt) and b.n_rows == 1


def _dense_gaps(ref: Reference, picks: Sequence[Served], group: Dict[float, Batch],
                key: str, device, control: Optional[Reference] = None):
    """Per request, the gaps of its served tokens (or of the control's
    first tokens) read alone or as padded, whichever is nearer; and how
    many took the padded reading."""
    rows, judged, served, where = [], [], [], []
    for s in picks:
        b = group[getattr(s, key)]
        widths = [len(s.prompt)] if b.width == len(s.prompt) else [len(s.prompt), b.width]
        for w in widths:
            padded = np.zeros(w, np.int64)
            padded[: len(s.prompt)] = s.prompt
            seq = np.concatenate([padded, s.tokens[:-1].astype(np.int64)])
            rows.append(torch.as_tensor(seq, device=device))
            judged.append((w - 1, w - 1 + s.n_steps))
            served.append(torch.as_tensor(s.tokens.astype(np.int64), device=device))
        where.append(len(widths))
    if not rows:
        return [], 0
    logits = ref.teacher_forced(rows, judged)
    if control is None:
        gaps = [_gaps(lg, t).cpu().numpy() for lg, t in zip(logits, served)]
    else:
        ctl = control.teacher_forced(rows, judged)
        gaps = [_gaps(lg, c.argmax(-1)).cpu().numpy() for lg, c in zip(logits, ctl)]
    alone, as_padded, at = [], [], 0
    for k in where:
        alone.append(gaps[at])
        as_padded.append(gaps[at + 1] if k == 2 else None)
        at += k
    return _nearer(alone, as_padded)


def _batch_gaps(ref: Reference, b: Batch, device, control: Optional[Reference] = None
                ) -> Dict[int, np.ndarray]:
    """The batch run whole: ``{rid: gaps}`` of its remote-answered rows."""
    prompt = np.zeros((b.n_rows, b.width), np.int64)
    forced = np.full((b.n_rows, b.steps), -1, np.int64)
    judged = []
    for r, s in enumerate(b.rows):
        prompt[r, : len(s.prompt)] = s.prompt
        if s.used_remote:
            forced[r, : s.n_steps] = s.tokens
            judged.append((r, s))
    p = torch.as_tensor(prompt, device=device)
    f = torch.as_tensor(forced, device=device)
    logits = ref.batch_decode(p, f)
    ctl = None if control is None else control.batch_decode(p, f)
    out = {}
    for r, s in judged:
        lg = logits[r, : s.n_steps]
        pick = (torch.as_tensor(s.tokens.astype(np.int64), device=device) if ctl is None
                else ctl[r, : s.n_steps].argmax(-1))
        out[s.rid] = _gaps(lg, pick).cpu().numpy()
    return out


def _expert_gaps(ref: Reference, batches_: Sequence[Batch], device,
                 control: Optional[Reference] = None):
    """Per remote-answered row of each batch, its gaps read alone (a batch
    of its own) or as its batch ran, whichever is nearer."""
    alone, as_padded = [], []
    for b in batches_:
        whole = _batch_gaps(ref, b, device, control)
        for s in b.rows:
            if s.rid not in whole:
                continue
            if _alone(s, b):
                alone.append(whole[s.rid])
                as_padded.append(None)
            else:
                own = Batch(rows=[s], width=len(s.prompt), n_rows=1, steps=s.n_steps)
                alone.append(_batch_gaps(ref, own, device, control)[s.rid])
                as_padded.append(whole[s.rid])
    return _nearer(alone, as_padded)


def sample_remote(served: Sequence[Served], group: Dict[float, Batch], expert: bool,
                  seed: int, tokens: int):
    """The remote-answered requests to score (dense) or the batches to run
    whole (experts): the longest request's first, then others in an order
    drawn from ``seed`` until ``tokens`` served tokens are in."""
    answered = [s for s in served if s.used_remote and s.tokens is not None]
    if not answered:
        return []
    longest = max(answered, key=lambda s: (group[s.remote_batch].width + s.n_steps, -s.rid))
    rng = np.random.default_rng(seed)
    if expert:
        keys = sorted({s.remote_batch for s in answered} - {longest.remote_batch})
        order = [longest.remote_batch] + [keys[i] for i in rng.permutation(len(keys))]
        picked, total = [], 0
        for k in order:
            picked.append(k)
            total += sum(s.n_steps for s in group[k].rows if s.used_remote)
            if total >= tokens:
                break
        return picked
    rest = [s for s in answered if s is not longest]
    order = [longest] + [rest[i] for i in rng.permutation(len(rest))]
    picked, total = [], 0
    for s in order:
        picked.append(s)
        total += s.n_steps
        if total >= tokens:
            break
    return picked


def judge(served: Sequence[Served], remote: Reference, hedge: Reference, seed: int,
          sample_tokens: int, device, control: Optional[Dict[str, Reference]] = None,
          gaps_out: Optional[Dict[str, np.ndarray]] = None, far_gap: float = 0.1
          ) -> Dict[str, float]:
    """The readings: ``unanswered``, ``short_answers``, ``remote_gap`` and
    ``hedge_gap`` (the widest gaps; NaN where no token was scored), with
    the scored token counts and how many requests took the padded
    reading.  With ``control`` ({"remote": ..., "hedge": ...}), the gaps
    are of the tokens the control puts first.  ``gaps_out``,
    where given, receives the scored tokens' gaps of each tier;
    ``remote_far_pct`` is the share of scored remote tokens more than
    ``far_gap`` below the reference's best."""
    control = control or {}
    unanswered = sum(s.tokens is None for s in served)
    short = sum(s.tokens is not None and len(s.tokens) != s.n_steps for s in served)
    ok = [s for s in served if s.tokens is not None and len(s.tokens) == s.n_steps]
    rgroup = batches(served, "remote_batch")  # every row a batch had
    expert = remote.kind == "moe"
    picks = sample_remote(ok, rgroup, expert, seed, sample_tokens)
    if expert:
        rg, r_padded = _expert_gaps(remote, [rgroup[k] for k in picks], device,
                                    control.get("remote"))
    else:
        rg, r_padded = _dense_gaps(remote, picks, rgroup, "remote_batch", device,
                                   control.get("remote"))
    n_remote = sum(g.size for g in rg)
    rg = np.concatenate(rg) if rg else np.zeros(0)
    remote.release()
    hpicks = [s for s in ok if s.used_remote is False]
    hgroup = batches(served, "hedge_batch")
    hg, h_padded = _dense_gaps(hedge, hpicks, hgroup, "hedge_batch", device,
                               control.get("hedge"))
    hg = np.concatenate(hg) if hg else np.zeros(0)
    if gaps_out is not None:
        gaps_out.update(remote=rg, hedge=hg)
    return {
        "unanswered": float(unanswered),
        "short_answers": float(short),
        "remote_gap": float(rg.max()) if rg.size else float("nan"),
        "remote_gap_mean": float(rg.mean()) if rg.size else float("nan"),
        "remote_far_pct": float(100.0 * (rg > far_gap).mean()) if rg.size else float("nan"),
        "remote_flip_pct": float(100.0 * (rg > 0).mean()) if rg.size else float("nan"),
        "remote_tokens_scored": float(n_remote),
        "remote_read_as_padded": float(r_padded),
        "hedge_gap": float(hg.max()) if hg.size else float("nan"),
        "hedge_tokens_scored": float(hg.size),
        "hedge_read_as_padded": float(h_padded),
    }


COMPARED = ("remote_gap", "remote_far_pct", "hedge_gap")


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [(name, value, limit)])``: the counts of requests with no
    answer or a short one (limit 0), then each gap the configuration holds
    to a limit; a gap with nothing scored is not compared."""
    rows = [("unanswered", readings["unanswered"], 0.0),
            ("short_answers", readings["short_answers"], 0.0)]
    for name in COMPARED:
        if name in limits and not np.isnan(readings[name]):
            rows.append((name, readings[name], float(limits[name])))
    return all(v <= lim for _, v, lim in rows), rows
