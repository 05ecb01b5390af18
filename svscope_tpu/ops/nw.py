"""Global pairwise alignment (Needleman-Wunsch, linear gap) and the
consensus MisScore.

Re-implements the role of Biopython pairwise2.align.globalms(seq1, seq2,
1, 0, -1, -1) in the reference (src/PairwiseCompare.py:19-30): MisScore =
alignment length - matches = mismatches + gap columns of one optimal
alignment.  Co-optimal alignments can differ in gap count, so the value
depends on traceback order; we fix the convention diagonal > up > left
(match preferred), which matches the common-case behavior.

The score DP row is vectorized with the same cummax trick as the POA
kernel; ops/nw_batch.py runs the batched device version in XLA.
"""
from __future__ import annotations

import numpy as np

MATCH = 1
MISMATCH = 0
GAP = -1


def nw_align_stats(seq1: str, seq2: str, match: int = MATCH,
                   mismatch: int = MISMATCH, gap: int = GAP):
    """Returns (score, matches, align_len) of one optimal global alignment
    with traceback preference diagonal > up > left."""
    a = np.frombuffer(seq1.encode(), np.uint8)
    b = np.frombuffer(seq2.encode(), np.uint8)
    m, n = len(a), len(b)
    H = np.empty((m + 1, n + 1), np.int32)
    H[0] = gap * np.arange(n + 1)
    decay = gap * np.arange(n + 1)
    for i in range(1, m + 1):
        sub = np.where(b == a[i - 1], match, mismatch).astype(np.int32)
        base = np.empty(n + 1, np.int32)
        base[0] = H[i - 1, 0] + gap
        base[1:] = np.maximum(H[i - 1, :-1] + sub, H[i - 1, 1:] + gap)
        H[i] = np.maximum.accumulate(base - decay) + decay
    # traceback
    i, j = m, n
    matches = 0
    align_len = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            s = match if a[i - 1] == b[j - 1] else mismatch
            if H[i, j] == H[i - 1, j - 1] + s:
                matches += int(a[i - 1] == b[j - 1])
                align_len += 1
                i -= 1
                j -= 1
                continue
        if i > 0 and H[i, j] == H[i - 1, j] + gap:
            align_len += 1
            i -= 1
            continue
        align_len += 1
        j -= 1
    return int(H[m, n]), matches, align_len


def alignment_misscore(som: str, germ: str) -> int:
    """AligmentScore (src/PairwiseCompare.py:19-30): align_len - matches."""
    _, matches, align_len = nw_align_stats(som, germ)
    return align_len - matches


def pick_misscore(scores: list[int]) -> int:
    """min-|.| with the reference's tie rule: smaller_absolute_value(old,
    new) keeps old only when strictly smaller, so ties go to the LATER pair
    (src/PairwiseCompare.py:32-36, 54-64)."""
    best = None
    for sc in scores:
        if best is None or not (abs(best) < abs(sc)):
            best = sc
    return int(best)


def calculate_misscore(som_seqs: list[str], germ_seqs: list[str]) -> int:
    """CalculateMisscore (src/PairwiseCompare.py:54-64): min-|.| over all
    som x germ pairs; negative when the somatic consensus is shorter."""
    scores = []
    for s in som_seqs:
        for g in germ_seqs:
            sc = alignment_misscore(s, g)
            if len(s) < len(g):
                sc = -sc
            scores.append(sc)
    return pick_misscore(scores)
