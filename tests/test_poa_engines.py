"""POA engine choice: every engine of poa_msa_batch gives the oracle's
MSA; the device engines refuse to run without the native C++ engine."""
import random

import pytest

from svscope_tpu.ops import poa_batch
from svscope_tpu.ops.poa import poa


def _windows():
    rng = random.Random(5)
    out = []
    for _ in range(6):
        ref = "".join(rng.choice("ACGT") for _ in range(40))
        ins = "".join(rng.choice("ACGT") for _ in range(6))
        out.append([ref] + [ref[:20] + ins + ref[20:] if i % 2 else ref
                            for i in range(5)])
    return out


@pytest.mark.parametrize("engine", [False, "xla", "fused"])
def test_engines_give_identical_msas(engine):
    wins = _windows()
    got = poa_batch.poa_msa_batch(wins, use_device=engine)
    assert got == [poa(w, 1) for w in wins]


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_device_engines_need_native(monkeypatch, engine):
    import svscope_tpu.native.poa as npoa
    monkeypatch.setattr(npoa, "native_available", lambda: False)
    with pytest.raises(RuntimeError, match="native C\\+\\+ engine"):
        poa_batch.poa_msa_batch(_windows(), use_device=engine)


def test_unknown_engine_rejected():
    with pytest.raises(ValueError, match="pallas"):
        poa_batch.poa_msa_batch(_windows(), use_device="pallas")
