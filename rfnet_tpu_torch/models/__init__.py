"""The networks the port serves. Each class names a ``state_dict`` key only
its weights hold (``KEY``), builds itself to the sizes its weights hold
(``for_weights``), takes ``generator``, ``dtype`` and its sizes as keywords,
and has ``input_points`` and ``output_points``. Nothing outside its file
reads more of it, so a new network is its file and a line of :data:`MODELS`.
"""

from rfnet_tpu_torch.models.rfnet import RFNet, RFNetOutputs
from rfnet_tpu_torch.models.snowflakenet import SnowflakeNet

# by the name eval --model takes
MODELS = {"rfnet": RFNet, "snowflakenet": SnowflakeNet}
DEFAULT = "rfnet"  # the network of a random init, and of weights no KEY names


def network_of(state_dict) -> str:
    """The name of the network whose weights ``state_dict`` holds: the
    first whose ``KEY`` it has, :data:`DEFAULT` where it has none."""
    return next((name for name, cls in MODELS.items() if cls.KEY in state_dict), DEFAULT)


__all__ = ["DEFAULT", "MODELS", "RFNet", "RFNetOutputs", "SnowflakeNet", "network_of"]
