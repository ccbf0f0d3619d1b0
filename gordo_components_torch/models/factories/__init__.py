"""Model factories; importing registers them."""

from gordo_components_torch.models.factories.feedforward import (  # noqa: F401
    FeedForwardAutoEncoder,
    feedforward_hourglass,
    feedforward_model,
    feedforward_symmetric,
    hourglass_calc_dims,
)
from gordo_components_torch.models.factories.lstm import (  # noqa: F401
    LSTMStack,
    lstm_hourglass,
    lstm_model,
    lstm_symmetric,
)
