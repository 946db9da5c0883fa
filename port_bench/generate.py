"""The benchmark's inputs, made from --seed with torch on the device.

* `genome`: uniform random A, C, G, T for each sequence of the
  configuration, at its name and length.
* `read_pool`: `calls` lists of reads. Every call holds the same multiset
  of reads, each a span on the genome and an error rate, drawn once from
  the mix's own `length_seed`, so every seed does the same amount of work
  in the same length buckets; the seed orders them, places them and
  mutates them. A read starts uniformly over the genome, weighted by each
  sequence's room for it, and never spans two sequences. Each base of the
  span is kept, substituted, deleted, or kept with a random base inserted
  after it, at the read's error rate and the mix's indel share; a read is
  reverse complemented at the mix's reverse share.

A traffic file (traffic/<name>.json) holds:
  reads_per_call, pool_calls, warmup_passes, check_reads,
  lengths: {"dist": "gamma", "mean", "stdev", "min", "max"},
           {"dist": "lognormal", "median", "sigma", "min", "max"} or
           {"dist": "uniform", "min", "max"} (bounds inclusive; a draw
           outside them is drawn again),
  length_seed, indel_share, reverse_share, and the error rate: either
  error_rate, one for every read, or identity: {"dist": "beta", "mean",
  "max", "stdev"}, a read's identity drawn as max times a beta variable
  of that mean and deviation (Badread's identity model), its error rate
  one less the identity.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_ASCII = torch.tensor(list(b"ACGT"), dtype=torch.uint8)
_CHUNK = 1 << 28  # bases a genome draw makes at once


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of --seed (any whole number)."""
    h = hashlib.blake2b(f"{seed}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") >> 1


def _gen(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag))
    return g


def genome(seqs: list[tuple[str, int]], seed: int, device):
    """([(name, ASCII bases)], [each sequence's codes 0-3, uint8 on the
    device]) of the configuration's sequences."""
    g = _gen(seed, "genome", device)
    lut = _ASCII.to(device)
    recs, codes = [], []
    for name, n in seqs:
        c = torch.cat([torch.randint(0, 4, (min(_CHUNK, n - a),), generator=g,
                                     device=device, dtype=torch.uint8)
                       for a in range(0, n, _CHUNK)]) if n else \
            torch.zeros(0, dtype=torch.uint8, device=device)
        recs.append((name, b"".join(lut[c[a:a + _CHUNK].long()].cpu().numpy().tobytes()
                                    for a in range(0, n, _CHUNK))))
        codes.append(c)
    return recs, codes


def _redraw(draw, lo: float, hi: float, n: int) -> np.ndarray:
    """n values of draw(size), each drawn again while outside [lo, hi]."""
    got = np.zeros(0)
    while got.shape[0] < n:
        d = draw(2 * n)
        got = np.concatenate([got, d[(d >= lo) & (d <= hi)]])
    return got[:n]


def call_lengths(mix: dict) -> np.ndarray:
    """The span of each read of a call: the same for every call and seed."""
    spec, n = mix["lengths"], int(mix["reads_per_call"])
    rng = np.random.default_rng(int(mix["length_seed"]))
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "uniform":
        return rng.integers(lo, hi + 1, size=n)
    if spec["dist"] == "lognormal":
        mu, sigma = np.log(float(spec["median"])), float(spec["sigma"])
        draw = lambda size: np.rint(rng.lognormal(mu, sigma, size=size))  # noqa: E731
    elif spec["dist"] == "gamma":
        mean, sd = float(spec["mean"]), float(spec["stdev"])
        shape, scale = (mean / sd) ** 2, sd * sd / mean
        draw = lambda size: np.rint(rng.gamma(shape, scale, size=size))  # noqa: E731
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return _redraw(draw, lo, hi, n).astype(np.int64)


def call_error_rates(mix: dict) -> np.ndarray:
    """The error rate of each read of a call, beside call_lengths' span:
    the same for every call and seed."""
    n = int(mix["reads_per_call"])
    if "identity" not in mix:
        return np.full(n, float(mix["error_rate"]))
    spec = mix["identity"]
    if spec["dist"] != "beta":
        raise ValueError(f"unknown identity distribution {spec['dist']!r}")
    top = float(spec["max"])
    m, v = float(spec["mean"]) / top, (float(spec["stdev"]) / top) ** 2
    common = m * (1 - m) / v - 1
    rng = np.random.default_rng([int(mix["length_seed"]), 1])
    return 1.0 - top * rng.beta(m * common, (1 - m) * common, size=n)


def _one_call(genome_t: list[torch.Tensor], seq_lens: torch.Tensor, spans: torch.Tensor,
              err: torch.Tensor, mix: dict, g: torch.Generator, device,
              truth: dict | None = None) -> list[bytes]:
    """One call's reads, of spans `spans` at error rates `err`; `truth`,
    where given, gets each read's sequence, start, strand, error rate and
    its counts of substitutions, deletions and insertions."""
    n = spans.shape[0]
    # where each read starts: a sequence with room for it, weighted by that room
    room = (seq_lens[None, :] - spans[:, None] + 1).clamp(min=0)
    cum = room.cumsum(1)
    if bool((cum[:, -1] == 0).any()):
        raise ValueError("a read is longer than every sequence")
    u = (torch.rand(n, generator=g, device=device, dtype=torch.float64)
         * cum[:, -1].to(torch.float64)).long().clamp(max=cum[:, -1] - 1)
    rid = torch.searchsorted(cum, u[:, None], right=True).flatten()
    start = u - torch.where(rid > 0, cum.gather(1, (rid - 1).clamp(min=0)[:, None]).flatten(), 0)
    # the spans' bases, read by read
    read_of = torch.repeat_interleave(torch.arange(n, device=device), spans)
    first = spans.cumsum(0) - spans
    at = start[read_of] + torch.arange(read_of.shape[0], device=device) - first[read_of]
    base = torch.empty(read_of.shape[0], dtype=torch.long, device=device)
    for r in torch.unique(rid).tolist():
        sel = rid[read_of] == r
        base[sel] = genome_t[r][at[sel]].long()
    # errors: keep, substitute, delete, or keep and insert after
    e, ind = err[read_of], float(mix["indel_share"])
    x = torch.rand(base.shape[0], generator=g, device=device, dtype=err.dtype)
    sub = x < e * (1 - ind)
    dele = (x >= e * (1 - ind)) & (x < e * (1 - ind / 2))
    ins = (x >= e * (1 - ind / 2)) & (x < e)
    shift = torch.randint(1, 4, base.shape, generator=g, device=device)
    base = torch.where(sub, (base + shift) % 4, base)
    extra = torch.randint(0, 4, base.shape, generator=g, device=device)
    reps = torch.where(dele, 0, torch.where(ins, 2, 1))
    slot = torch.stack([base, extra], 1).flatten()
    keep = (torch.arange(2, device=device)[None, :] < reps[:, None]).flatten()
    codes = slot[keep]
    owner = read_of.repeat_interleave(reps)
    qlen = torch.bincount(owner, minlength=n)
    # the reverse strand: reversed within the read, complemented
    rev = torch.rand(n, generator=g, device=device) < float(mix["reverse_share"])
    qfirst = qlen.cumsum(0) - qlen
    pos = torch.arange(codes.shape[0], device=device) - qfirst[owner]
    src = torch.where(rev[owner], qfirst[owner] + qlen[owner] - 1 - pos, qfirst[owner] + pos)
    codes = torch.where(rev[owner], 3 - codes[src], codes[src])
    if truth is not None:
        count = lambda m: torch.bincount(read_of[m], minlength=n).cpu()  # noqa: E731
        truth.update(rid=rid.cpu(), start=start.cpu(), rev=rev.cpu(), span=spans.cpu(),
                     err=err.cpu(),
                     sub=count(sub), dele=count(dele), ins=count(ins))
    blob = _ASCII.to(device)[codes].cpu().numpy().tobytes()
    ends = qfirst.add(qlen).tolist()
    return [blob[a:b] for a, b in zip(qfirst.tolist(), ends)]


def read_pool(codes: list[torch.Tensor], mix: dict, seed: int, calls: int,
              device, truth: list | None = None) -> list[list[tuple[str, bytes]]]:
    """`calls` lists of mix["reads_per_call"] (name, bases) reads from
    the genome's codes (genome's second value); `truth`, where given,
    gets each call's truth dict (_one_call)."""
    g = _gen(seed, "reads", device)
    seq_lens = torch.tensor([c.shape[0] for c in codes], device=device)
    lengths = torch.from_numpy(call_lengths(mix)).to(device)
    rates = torch.from_numpy(call_error_rates(mix)).to(device)
    pool = []
    for c in range(calls):
        perm = torch.randperm(lengths.shape[0], generator=g, device=device)
        t = {} if truth is not None else None
        seqs = _one_call(codes, seq_lens, lengths[perm], rates[perm], mix, g, device, t)
        if truth is not None:
            truth.append(t)
        pool.append([(f"c{c:03d}r{i:05d}", s) for i, s in enumerate(seqs)])
    return pool
