"""Byte-pair encoding over token streams (lyrics words or MIDI events).

Port of ``fewshot/data/bpe.py``: the same merges, in the same order, for the
same input, and the same ``bpe.json``, so a BPE corpus packed by either
package loads in both.  Merging frequent adjacent pairs shortens the
sequences the recurrence walks step by step.  Offline only: merges are
learned once (``learn_bpe``), applied at pack time (``encode``) and inverted
after sampling (``expand``).  Merged tokens get readable names ("w1+w2");
``expand`` restores base ids, so MIDI decoding and detokenization work
unchanged.  Per-token NLL under BPE is per BPE token: rescale with
``episodes.base_token_ratio`` to compare with a base-token NLL.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path

from fewshot_torch.data.vocab import SPECIALS, Vocab


def learn_bpe(sequences: list[list[int]], vocab: Vocab,
              num_merges: int, min_count: int = 2
              ) -> tuple[Vocab, list[tuple[int, int, int]]]:
    """Learn merges over int sequences; returns (extended vocab, merges).

    merges: ordered [(left_id, right_id, new_id)].  Specials never merge.

    Incremental algorithm: all sequences live in one doubly-linked array;
    pair counts update only around each merged occurrence and a lazy
    max-heap (stale entries discarded on pop) picks the next merge:
    O(corpus + merges log) instead of a full recount per merge.  Picks and
    tie-breaks (max count, then max (a, b)) are those of the recount.
    """
    import heapq

    tokens = list(vocab.tokens)
    merges: list[tuple[int, int, int]] = []
    n_special = len(SPECIALS)

    # One flat doubly-linked list over all sequences (-1 = boundary/dead).
    tok: list[int] = []
    prv: list[int] = []
    nxt: list[int] = []
    for s in sequences:
        start = len(tok)
        for j, t in enumerate(s):
            tok.append(int(t))
            prv.append(start + j - 1 if j > 0 else -1)
            nxt.append(start + j + 1 if j + 1 < len(s) else -1)

    def mergeable(a: int, b: int) -> bool:
        return a >= n_special and b >= n_special

    # Initial counts + occurrence lists (left-node index per occurrence).
    counts: Counter = Counter()
    occs: dict[tuple[int, int], list[int]] = {}
    for i in range(len(tok)):
        j = nxt[i]
        if j != -1 and mergeable(tok[i], tok[j]):
            p = (tok[i], tok[j])
            counts[p] += 1
            occs.setdefault(p, []).append(i)

    # Lazy max-heap: (-count, -a, -b, a, b); an entry is valid iff its
    # count still matches counts[(a, b)].  Every count CHANGE pushes a
    # fresh entry, so the current count of every candidate is always
    # represented.
    heap: list[tuple[int, int, int, int, int]] = [
        (-c, -a, -b, a, b) for (a, b), c in counts.items()]
    heapq.heapify(heap)

    def bump(a: int, b: int, delta: int, pos: int | None = None) -> None:
        p = (a, b)
        counts[p] += delta
        if pos is not None:
            occs.setdefault(p, []).append(pos)
        c = counts[p]
        if c >= min_count:
            heapq.heappush(heap, (-c, -a, -b, a, b))

    while len(merges) < num_merges:
        # pop until a live entry surfaces
        a = b = -1
        count = 0
        while heap:
            negc, _, _, a, b = heapq.heappop(heap)
            if counts[(a, b)] == -negc:
                count = -negc
                break
        else:
            break
        if count < min_count:
            break

        new_id = len(tokens)
        tokens.append(f"{tokens[a]}+{tokens[b]}")
        merges.append((a, b, new_id))

        # Greedy left-to-right, non-overlapping — matches _merge_pair.
        # Occurrences were appended in position order, so iterating the
        # list preserves the reference's left-to-right semantics.
        for i in occs.pop((a, b), ()):
            if tok[i] != a:                       # stale (node merged away)
                continue
            j = nxt[i]
            if j == -1 or tok[j] != b:            # stale
                continue
            p, n = prv[i], nxt[j]
            # retire pairs that touched this occurrence (bump pushes a
            # fresh heap entry at the DECREASED count too — without it a
            # pair whose count only ever drops would lose its heap
            # representation and never be picked again)
            counts[(a, b)] -= 1
            if p != -1 and mergeable(tok[p], a):
                bump(tok[p], a, -1)
            if n != -1 and mergeable(b, tok[n]):
                bump(b, tok[n], -1)
            # splice: node i becomes new_id, node j dies
            tok[i] = new_id
            tok[j] = -1
            nxt[i] = n
            if n != -1:
                prv[n] = i
            # new pairs around the merged token
            if p != -1 and mergeable(tok[p], new_id):
                bump(tok[p], new_id, +1, pos=p)
            if n != -1 and mergeable(new_id, tok[n]):
                bump(new_id, tok[n], +1, pos=i)
        counts[(a, b)] = 0

    return Vocab(tokens), merges


def _merge_pair(seq: list[int], a: int, b: int, new_id: int) -> list[int]:
    out: list[int] = []
    i = 0
    n = len(seq)
    while i < n:
        if i + 1 < n and seq[i] == a and seq[i + 1] == b:
            out.append(new_id)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return out


def encode(seq: list[int], merges: list[tuple[int, int, int]]) -> list[int]:
    """Apply merges (standard BPE encode).

    Equivalent to applying every merge in learned order, but skips merges
    absent from the sequence: repeatedly merge the LOWEST-RANK pair present
    (classic trained-BPE encode) — O(len · applied) instead of
    O(len · num_merges), which dominated pack time at vocab scale."""
    rank = {(a, b): (r, new_id) for r, (a, b, new_id) in enumerate(merges)}
    s = list(seq)
    while len(s) > 1:
        best = None
        for pair in zip(s, s[1:]):
            r = rank.get(pair)
            if r is not None and (best is None or r[0] < best[0]):
                best = (r[0], pair[0], pair[1], r[1])
        if best is None:
            break
        s = _merge_pair(s, best[1], best[2], best[3])
    return s


def expand(seq, merges: list[tuple[int, int, int]]) -> list[int]:
    """Invert merges: recursively restore base token ids."""
    table = {new_id: (a, b) for a, b, new_id in merges}

    def rec(tid: int, out: list[int]) -> None:
        pair = table.get(tid)
        if pair is None:
            out.append(tid)
        else:
            rec(pair[0], out)
            rec(pair[1], out)

    out: list[int] = []
    for t in seq:
        rec(int(t), out)
    return out


def save_merges(merges, path: str | Path) -> None:
    Path(path).write_text(json.dumps(merges))


def load_merges(path: str | Path) -> list[tuple[int, int, int]]:
    return [tuple(m) for m in json.loads(Path(path).read_text())]
