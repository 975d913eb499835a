"""The port's test modules run at one torch intra-op thread from the root
conftest.py alone: this file declares no fixture of its own."""

import torch


def test_port_tests_run_at_one_torch_thread():
    assert torch.get_num_threads() == 1
