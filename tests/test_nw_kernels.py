import numpy as np

from svscope_tpu.ops.nw import (alignment_misscore, calculate_misscore,
                                nw_align_stats, pick_misscore)


def _random_pairs(rng, n, lmax):
    pairs = []
    for _ in range(n):
        la, lb = rng.integers(1, lmax, 2)
        pairs.append(("".join(rng.choice(list("ACGT"), la)),
                      "".join(rng.choice(list("ACGT"), lb))))
    return pairs


def test_pick_misscore_tie_rule():
    # reference's smaller_absolute_value keeps old only when strictly
    # smaller -> ties go to the LATER pair
    assert pick_misscore([5, -5]) == -5
    assert pick_misscore([-5, 5]) == 5
    assert pick_misscore([3, -5, 5]) == 3


def test_nw_stats_batch_parity():
    from svscope_tpu.ops.nw_batch import misscore_batch
    rng = np.random.default_rng(0)
    pairs = _random_pairs(rng, 24, 120)
    base = "".join(rng.choice(list("ACGT"), 200))
    pairs += [(base, base[:100] + "TTTT" + base[100:]), (base, base)]
    exp = [al - m for (_, m, al) in (nw_align_stats(a, b) for a, b in pairs)]
    got = misscore_batch(pairs)
    assert (np.array(exp) == got).all()


def test_edit_distance_matches_levenshtein():
    import Levenshtein
    from svscope_tpu.ops.nw_batch import (edit_distance_batch,
                                          pairwise_edit_distance_matrix)
    rng = np.random.default_rng(3)
    pairs = _random_pairs(rng, 20, 100) + [("", "ACGT"), ("A", "")]
    exp = np.array([Levenshtein.distance(a, b) for a, b in pairs])
    assert (edit_distance_batch(pairs) == exp).all()
    seqs = ["ACGT", "AGT", "TTTT", ""]
    M = pairwise_edit_distance_matrix(seqs)
    E = np.array([[Levenshtein.distance(a, b) for b in seqs] for a in seqs])
    assert (M == E).all()
