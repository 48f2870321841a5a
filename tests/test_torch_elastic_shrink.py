"""The port loop's elastic shrinks (4 -> 2 ranks over dp, dp x fsdp 2 and
dp x tp 2, and dp with 2-step gradient accumulation) against the restore
reference, bit for bit, and against JAX's elastic run (8 -> 4 virtual
devices) within the gang tolerance: the cases of
``tests/test_torch_elastic_loop.py``, which runs the grows."""

import pytest

pytest.importorskip("torch")

from test_torch_elastic_loop import SHRINK, check_reshard_point  # noqa: E402


@pytest.mark.parametrize("case", list(SHRINK))
def test_shrink_is_the_restore_reference_and_jax_s(case, tmp_path):
    check_reshard_point(*SHRINK[case], tmp_path)
