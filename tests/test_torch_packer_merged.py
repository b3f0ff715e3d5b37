"""The port's plain merged word fill (FLAC_TPU_PACKER=merged) against
flac_tpu's pack_fields_pallas_merged in interpret mode, bit for bit, on the
random cases of tests/test_packer_pallas.py (inputs from their seeds,
numpy). The degenerate cases are in test_torch_packer.py; interpret mode
takes seconds a case, so they are split to keep each file short."""

from __future__ import annotations

import pytest

from test_torch_packer import _merged_matches_interpret


@pytest.mark.parametrize("name", ["random0", "random1", "random2"])
def test_plain_merged_fill_matches_pallas_merged_interpret(name):
    _merged_matches_interpret(name)
