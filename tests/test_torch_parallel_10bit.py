"""The port's row-banded intra RD against the JAX package's at 10 bits
(see test_torch_parallel.py).  Its own file, so that the reference's 10-bit
programs compile in a process of their own."""

import pytest
import torch

from test_torch_parallel import check_size_rd

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("s", [4, 8, 16, 32])
def test_sharded_size_rd_10bit_equals_jax(n, s):
    check_size_rd(n, s, 10)
