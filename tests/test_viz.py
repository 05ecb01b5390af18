import os

import pytest

from svscope_tpu.cli import main

from synth import make_test_pair


def test_viz_cli(tmp_path):
    d = str(tmp_path)
    ref, tumor, normal, recs, refseq = make_test_pair(d, seed=2)
    out = main(["viz", "-w", "chr1:1000-1100", "-T", tumor, "-N", normal,
                "-t", "S", "-n", "S", "-r", ref, "-s", d + "/viz"])
    assert out.endswith("chr1_1000-1100.window.png")
    assert os.path.getsize(out) > 20_000  # a real rendered figure


def test_viz_window_without_reads(tmp_path):
    d = str(tmp_path)
    ref, tumor, normal, recs, refseq = make_test_pair(d, seed=2)
    with pytest.raises(Exception):
        main(["viz", "-w", "chr1:58000-58100", "-T", tumor, "-N", normal,
              "-t", "S", "-n", "S", "-r", ref, "-s", d + "/viz"])


@pytest.mark.parametrize("name", ["matplotlib", "networkx"])
def test_viz_names_the_extra_when_missing(monkeypatch, name):
    """matplotlib/networkx stay behind the 'viz' extra: without them the
    viz path fails with an ImportError that says how to install them."""
    import sys
    from svscope_tpu.viz.scopeviz import _viz_import
    monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match=r"svscope-tpu\[viz\]"):
        _viz_import(name)
