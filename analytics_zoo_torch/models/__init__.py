from analytics_zoo_torch.models.common import ZooModel

__all__ = ["ZooModel"]
