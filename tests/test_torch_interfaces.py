"""The port's ``interfaces.py``: its model classes conform to the four
Protocols (``tests/test_aux.py:101``'s check, with the expert added), and
objects without the methods do not."""

import pytest

from gan_mpc_tpu_torch.interfaces import CostModel, CriticModel, DynamicsModel, ExpertModel
from gan_mpc_tpu_torch.models.cost import CostFeatureNet, MPCCost
from gan_mpc_tpu_torch.models.critic import SequenceCritic
from gan_mpc_tpu_torch.models.dynamics import (
    LearnedDynamics,
    LSTMDynamicsNet,
    ResidualMLPDynamicsNet,
)
from gan_mpc_tpu_torch.models.ensemble import EnsembleDynamics
from gan_mpc_tpu_torch.models.expert import ExpertPredictor


@pytest.mark.parametrize("model, protocol", [
    (MPCCost(CostFeatureNet(3), 5), CostModel),
    (LearnedDynamics(ResidualMLPDynamicsNet(3, 1)), DynamicsModel),
    (LearnedDynamics(LSTMDynamicsNet(3, 1, features=8, hidden=(16,))), DynamicsModel),
    (EnsembleDynamics([ResidualMLPDynamicsNet(3, 1, (16,)) for _ in range(2)]), DynamicsModel),
    (SequenceCritic(3), CriticModel),
    (ExpertPredictor(3, 1, arch="lstm", features=8, hidden=(16,)), ExpertModel),
    (ExpertPredictor(3, 1, arch="mlp", features=0, hidden=(16,)), ExpertModel),
], ids=["cost", "mlp_dynamics", "lstm_dynamics", "ensemble", "critic", "lstm_expert",
        "mlp_expert"])
def test_models_conform(model, protocol):
    assert isinstance(model, protocol)


def test_nets_without_the_methods_do_not_conform():
    net = CostFeatureNet(3)
    for protocol in (CostModel, DynamicsModel, ExpertModel):
        assert not isinstance(net, protocol)
    assert not isinstance(ResidualMLPDynamicsNet(3, 1), DynamicsModel)  # no carry methods
    assert not isinstance(object(), CriticModel)
