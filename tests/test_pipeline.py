"""End-to-end CLI pipeline tests over the synthetic tumor/normal pair."""
import os

import numpy as np
import pytest

from svscope_tpu.cli import main
from svscope_tpu.ops.nw import alignment_misscore, calculate_misscore

from synth import make_test_pair


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("e2e"))
    ref, tumor, normal, recs, refseq = make_test_pair(d)
    repeats = os.path.join(d, "repeats.bed")
    open(repeats, "w").close()
    savedir = os.path.join(d, "out")
    main(["DataPrepare", "-D", repeats, "-T", tumor, "-N", normal,
          "-t", "S", "-n", "S", "-r", ref, "-s", savedir,
          "--selectwindows", "--FullProcess"])
    return d, ref, tumor, normal, savedir


def test_outputs_exist(full_run):
    d, ref, tumor, normal, savedir = full_run
    for name in ["S.vs.S.TandemRepeat.Raw.bed", "S.Somatic.bed",
                 "RandomForestResult.tsv", "S.vcf", "S.mergedSomatic.vcf",
                 "InterALNSVs.vcf",
                 "CandidateSpan.tumor.merged.decision.somatic.bed"]:
        assert os.path.exists(os.path.join(savedir, name)), name


def test_raw_bed_somatic_call(full_run):
    d, ref, tumor, normal, savedir = full_run
    rows = [l.split("\t") for l in
            open(os.path.join(savedir, "S.vs.S.TandemRepeat.Raw.bed"))
            .read().splitlines()]
    em = [r for r in rows if r[9] == "NormalOutput|EMOutput"]
    assert len(em) == 1
    r = em[0]
    som_names = {x.split("|")[1] for x in r[4].replace(";", ",").split(",")}
    assert som_names == {f"w0t{i}" for i in range(5)}
    # somatic consensus carries the 60bp insertion
    assert max(len(s) for s in r[3].split(";")) - \
        max(len(s) for s in r[6].split(";")) > 40


def test_inner_vcf_record(full_run):
    d, ref, tumor, normal, savedir = full_run
    body = [l for l in open(os.path.join(savedir, "S.vcf")).read().splitlines()
            if not l.startswith("#")]
    assert len(body) == 1
    cols = body[0].split("\t")
    assert cols[2].startswith("TDscope.INS.chr1_")
    info = dict(kv.split("=", 1) for kv in cols[7].split(";"))
    assert 50 <= int(info["SVLEN"]) <= 95
    assert info["SVTYPE"] == "INS"
    assert int(info["SUPPORT"]) == 5
    assert "ConfidenceSV" in info and "DecisionSV" in info
    af = float(info["AF"].split(";")[0])
    assert 0 < af < 1
    # REF=germline consensus, ALT=somatic consensus
    assert len(cols[4]) - len(cols[3]) > 40


def test_rf_features_finite(full_run):
    import pandas as pd
    d, ref, tumor, normal, savedir = full_run
    rf = pd.read_csv(os.path.join(savedir, "RandomForestResult.tsv"), sep="\t")
    assert len(rf) == 1
    row = rf.iloc[0]
    for col in ["COV_Tumor", "mapQ_Tumor", "COV_Normal", "mapQ_Normal",
                "ABSMisScore", "AdaptRatio_T", "AdaptRatio_N"]:
        assert np.isfinite(row[col]), col
    assert 50 <= row["ABSMisScore"] <= 95
    assert 0 <= row["yprob"] <= 1


def test_adjust_vcf(full_run):
    d, ref, tumor, normal, savedir = full_run
    out = main(["adjustVCF", "-s", savedir])
    assert out.endswith(".mergedSomatic.adjusted.vcf")
    assert os.path.exists(out)


def test_npz_replay_matches_direct(tmp_path):
    d = str(tmp_path)
    ref, tumor, normal, recs, refseq = make_test_pair(d, seed=3)
    repeats = os.path.join(d, "repeats.bed")
    open(repeats, "w").close()
    sd_direct = os.path.join(d, "direct")
    sd_npz = os.path.join(d, "npz")
    main(["DataPrepare", "-D", repeats, "-T", tumor, "-N", normal,
          "-t", "S", "-n", "S", "-r", ref, "-s", sd_direct,
          "--selectwindows", "--FullProcess"])
    main(["DataPrepare", "-D", repeats, "-T", tumor, "-N", normal,
          "-t", "S", "-n", "S", "-r", ref, "-s", sd_npz,
          "--selectwindows", "--saveData"])
    main(["localGraph_npz", "-t", "S", "-n", "S", "-s", sd_npz])
    raw_a = open(os.path.join(sd_direct, "S.vs.S.TandemRepeat.Raw.bed")).read()
    raw_b = open(os.path.join(sd_npz, "S.vs.S.TandemRepeat.Raw.bed")).read()
    assert raw_a == raw_b


def test_misscore_values():
    assert alignment_misscore("ACGT", "ACGT") == 0
    assert alignment_misscore("ACGT", "ACTT") == 1
    assert alignment_misscore("ACGTTT", "ACGT") == 2
    # min-|.|, negative when somatic shorter
    assert calculate_misscore(["ACGT"], ["ACGTTTTT"]) == -4
    assert calculate_misscore(["ACGTTTTT", "ACGT"], ["ACGTT"]) == -1


def test_multi_sample_bams(tmp_path):
    """Comma-separated multi-BAM inputs (reference supports multiple
    tumor/normal samples per run)."""
    d = str(tmp_path)
    ref, tumor, normal, recs, refseq = make_test_pair(d, seed=6)
    # split the tumor records over two BAMs
    from svscope_tpu.io.bam import BamReader, BamWriter
    rd = BamReader(tumor)
    t1, t2 = str(tmp_path / "t1.bam"), str(tmp_path / "t2.bam")
    with BamWriter(t1, rd.references, rd.lengths) as w1, \
         BamWriter(t2, rd.references, rd.lengths) as w2:
        for i, r in enumerate(rd.records):
            (w1 if i % 2 == 0 else w2).write(r)
    out = main(["localGraph", "-w", "/dev/stdin", "-T", f"{t1},{t2}",
                "-N", normal, "-t", "A,B", "-n", "C", "-r", ref,
                "-s", d + "/ms"]) if False else None
    # use a temp window bed instead of stdin
    wb = str(tmp_path / "w.bed")
    open(wb, "w").write("\n".join(recs) + "\n")
    out = main(["localGraph", "-w", wb, "-T", f"{t1},{t2}", "-N", normal,
                "-t", "A,B", "-n", "C", "-r", ref, "-s", d + "/ms"])
    assert out.endswith("A-B.vs.C.TandemRepeat.Raw.bed")
    rows = [l.split("\t") for l in open(out).read().splitlines()]
    em = [r for r in rows if r[9].endswith("EMOutput")]
    assert len(em) == 1
    # somatic reads carry per-sample labels A_tumor / B_tumor
    labels = {x.split("|")[0] for x in em[0][4].replace(";", ",").split(",")}
    assert labels == {"A_tumor", "B_tumor"}


def test_empty_run_no_svs(tmp_path):
    """A pair with zero somatic SVs flows through the full pipeline into
    header-only VCFs (the reference crashes on the empty Somatic.bed)."""
    d = str(tmp_path)
    wins = [dict(start=5000, end=5100, svtype=None, svlen=0, som_reads=0,
                 depth=10)]
    ref, tumor, normal, recs, _ = make_test_pair(d, seed=17, ref_len=40_000,
                                                 windows=wins)
    repeats = os.path.join(d, "repeats.bed")
    open(repeats, "w").close()
    savedir = os.path.join(d, "out")
    main(["DataPrepare", "-D", repeats, "-T", tumor, "-N", normal,
          "-t", "S", "-n", "S", "-r", ref, "-s", savedir,
          "--selectwindows", "--FullProcess"])
    for name in ("S.vcf", "S.mergedSomatic.vcf"):
        body = [l for l in open(os.path.join(savedir, name))
                if not l.startswith("#")]
        assert body == []
    adjusted = main(["adjustVCF", "-s", savedir])
    assert os.path.exists(adjusted)


def test_cli_friendly_missing_file_error(capsys):
    import pytest as _pytest
    from svscope_tpu import cli
    with _pytest.raises(SystemExit):
        cli.main(["localGraph", "-w", "/nope.bed", "-T", "/no.bam",
                  "-N", "/no2.bam", "-t", "T", "-n", "N",
                  "-r", "/no.fa", "-s", "/tmp/x"])
    err = capsys.readouterr().err
    assert "not found" in err


MAIN_PATH_IMPORTS = r"""
import importlib.metadata, json, os, sys, sysconfig
sys.path[:0] = [{repo!r}, {tests!r}]
site = sysconfig.get_paths()["purelib"]

def third_party():
    out = set()
    for name, mod in list(sys.modules.items()):
        f = getattr(mod, "__file__", None) or ""
        if f.startswith(site):
            out.add(name.split(".")[0])
    return out

import jax, numpy, scipy  # noqa: E401
base = third_party()
from synth import make_test_pair
from svscope_tpu.cli import main
d = {tmp!r}
ref, tumor, normal, recs, _ = make_test_pair(d)
rep = os.path.join(d, "rep.bed")
open(rep, "w").close()
before = third_party()
main(["DataPrepare", "-D", rep, "-T", tumor, "-N", normal, "-t", "S",
      "-n", "S", "-r", ref, "-s", os.path.join(d, "o"), "--selectwindows",
      "--FullProcess"])
main(["adjustVCF", "-s", os.path.join(d, "o")])
print(json.dumps(sorted(third_party() - base)))
"""


def test_main_path_imports_only_jax_numpy_scipy(tmp_path):
    """DataPrepare --selectwindows --FullProcess + adjustVCF through the
    CLI loads no third-party package beyond JAX (and what JAX itself
    loads), NumPy and SciPy — nothing a GPU host may lack."""
    import json
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    code = MAIN_PATH_IMPORTS.format(repo=os.path.dirname(here), tests=here,
                                    tmp=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    extra = json.loads(r.stdout.strip().splitlines()[-1])
    assert extra == [], f"main path imported {extra}"


@pytest.mark.parametrize("value,engine", [("host", False), ("xla", "xla"),
                                          ("fused", "fused"),
                                          ("pallas", None)])
def test_device_poa_option(value, engine, capsys):
    """--device-poa: 'host' (the default) is the C++ engine; 'pallas' is
    no longer a choice."""
    import argparse
    from svscope_tpu.cli import _device_poa_arg
    if engine is None:
        with pytest.raises(SystemExit):
            main(["localGraph", "--device-poa", value, "-w", "x", "-T", "x",
                  "-N", "x", "-t", "S", "-n", "S", "-r", "x", "-s", "x"])
        assert "invalid choice" in capsys.readouterr().err
    else:
        assert _device_poa_arg(argparse.Namespace(device_poa=value)) == engine
