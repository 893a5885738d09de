"""On the card: a cell at its own size comes out correct, and the control
(the reference in TF32 in the program's place) comes out not correct.
Skips without a CUDA card; run on the card with

    python -m pytest -p no:cacheprovider -m cuda regbench/tests/test_regbench_card.py
"""
import time

import pytest

from regbench import check
from regbench.harness import load_spec, run_cell


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["resso60k.batch8", "tls131k.batch8",
                                  "resso60k.single"])
def test_program_correct_and_control_not(card, cell):
    def both(*a, **kw):
        both.control = check.check(*a, control=True, **kw)
        return check.check(*a, **kw)

    result, _, _ = run_cell(load_spec(cell), 2147483647, 6.0, False,
                            time.perf_counter(), check_fn=both)
    assert result["correct"], result["checks"]
    failed = {name for name, _, _, ok in both.control if not ok}
    assert {"spacing_gap", "k2_gap", "k1_gap"} <= failed
