"""The port's library constructors run on the card unless the caller asks for
the CPU: without CUDA, a call that names no device raises and never falls
back to the CPU; with a card, the same call builds on it."""

import pytest
import torch

from vln_bevbert_tpu_torch.configs import FinetuneConfig, PretrainConfig
from vln_bevbert_tpu_torch.nav.agent import make_replay_agent
from vln_bevbert_tpu_torch.parallel.train_step import init_pretrain_state

CONSTRUCTORS = {
    "init_pretrain_state": lambda: init_pretrain_state(PretrainConfig(), 0)[0],
    "make_replay_agent": lambda: make_replay_agent(FinetuneConfig(), 2).model,
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CONSTRUCTORS[name]()
        return
    model = CONSTRUCTORS[name]()
    assert {p.device.type for p in model.parameters()} == {"cuda"}
