from analytics_zoo_torch.models.textmatching.knrm import KNRM, KernelPooling

__all__ = ["KNRM", "KernelPooling"]
