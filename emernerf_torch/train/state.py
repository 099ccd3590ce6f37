"""Training state (port of ``emernerf_tpu/train/state.py``): the step, the
model and proposal modules (their parameters are the master params) and
the two Adam states, updated in place by the train step."""

from __future__ import annotations

import dataclasses
from typing import List

from torch import nn

from emernerf_torch.train.optim import AdamState, make_adam


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    prop_models: List[nn.Module]
    opt_state: AdamState
    prop_opt_state: AdamState

    @property
    def params(self) -> List[nn.Parameter]:
        return list(self.model.parameters())

    @property
    def prop_params(self) -> List[nn.Parameter]:
        return [p for pm in self.prop_models for p in pm.parameters()]


def init_train_state(model: nn.Module, prop_models) -> TrainState:
    """Step 0 with fresh Adam moments for the model and for all proposal
    nets together (one count each, as in the reference)."""
    tx = make_adam()
    prop_models = list(prop_models)
    return TrainState(0, model, prop_models, tx.init(list(model.parameters())),
                      tx.init([p for pm in prop_models for p in pm.parameters()]))
