"""CPU tests of chip_smoke.py: it refuses to run without a GPU, and its
phase functions hold at tiny sizes (here the "device" is the CPU backend,
compared against the same references the card is held to)."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_exits_nonzero_without_gpu(tmp_path, where):
    """No card here: the script must fail and print no ok line, both in
    the repository and copied alone into an empty directory."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_em_parity_small():
    r = cs.em_parity(cs.soak_features(12, seed=3))
    assert r["windows"] == 12 and r["max_bic_rel_err"] <= cs.BIC_RTOL


def test_em_parity_detects_label_mismatch(monkeypatch):
    """The comparison is live: a perturbed device result must fail it."""
    from svscope_tpu.models import mixture as mx
    real = mx.em_cluster_batch_dispatch
    calls = []

    def flipped(feats, **kw):
        fetch = real(feats, **kw)

        def fetch2():
            out = fetch()
            if not calls:                      # the device side only
                out[0][2] = np.roll(out[0][2], 1)
                out[0][2][0] = out[0][2].max() + 1
            calls.append(1)
            return out
        return fetch2
    monkeypatch.setattr(mx, "em_cluster_batch_dispatch", flipped)
    with pytest.raises(AssertionError):
        cs.em_parity(cs.soak_features(4, seed=3))


def test_aligner_parity_small():
    r = cs.aligner_parity(cs.aligner_cases(4, 60, 4, seed=1),
                          with_memory=True)
    assert r["windows"] == 4 and r["bucket"] == [128, 128]


def test_fused_parity_small():
    import bench
    wins = bench.make_window_payloads(2, np.random.default_rng(0),
                                      n_reads=4, ins_carriers=2)
    r = cs.fused_parity([w.sequences[:3] for w in wins])
    assert r["windows"] == 2


def test_nw_parity_small():
    r = cs.nw_parity(cs.nw_pairs(6, 90, 120, seed=2), 128, with_memory=True)
    assert r["pairs"] == 6


def test_forest_parity_small():
    r = cs.forest_parity(cs.forest_features(64, seed=1))
    assert r["max_abs_err"] <= cs.FOREST_ATOL


def test_score_calls(tmp_path):
    """Precision counts calls on truth, recall counts truth spans hit."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import genome_bench as gb
    classes = {c: [] for c in gb.SLOT_CLASSES}
    classes[gb.TRUTH_CLASSES[0]] = [("chr1", 100, 200, "INS", 60),
                                    ("chr1", 900, 1000, "DEL", 70)]
    vcf = tmp_path / "m.vcf"
    vcf.write_text("##x\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
                   "chr1\t150\t.\tN\tN\t.\tPASS\tSVLEN=60;END=160\n"
                   "chr1\t5000\t.\tN\tN\t.\tPASS\tSVLEN=60;END=5010\n")
    assert cs.score_calls(str(vcf), classes) == (0.5, 0.5)
