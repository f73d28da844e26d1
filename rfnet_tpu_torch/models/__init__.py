from rfnet_tpu_torch.models.rfnet import RFNet, RFNetOutputs

__all__ = ["RFNet", "RFNetOutputs"]
