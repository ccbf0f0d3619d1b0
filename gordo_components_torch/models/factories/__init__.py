"""Model factories; importing registers them."""

from gordo_components_torch.models.factories.conv import (  # noqa: F401
    Conv1DAutoEncoder,
    conv1d_autoencoder,
)
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
from gordo_components_torch.models.factories.variational import (  # noqa: F401
    VariationalAutoEncoder,
    feedforward_variational,
)
