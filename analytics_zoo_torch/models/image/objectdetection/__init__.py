"""Object detection: SSD graphs, priors, box codec, NMS, the MultiBox
loss, VOC mAP and the ``ObjectDetector`` facade.  The torchvision-derived
pretrained detectors (``pretrained*.py``) are not ported yet."""
from analytics_zoo_torch.models.image.objectdetection.bbox import (
    decode_boxes, encode_boxes, iou_matrix,
)
from analytics_zoo_torch.models.image.objectdetection.nms import (
    multiclass_nms, nms,
)
from analytics_zoo_torch.models.image.objectdetection.prior_box import (
    ssd_priors,
)
from analytics_zoo_torch.models.image.objectdetection.multibox_loss import (
    MultiBoxLoss, match_priors,
)
from analytics_zoo_torch.models.image.objectdetection.ssd import (
    SSDDetector, ssd_lite, ssd_vgg300,
)
from analytics_zoo_torch.models.image.objectdetection.evaluation import (
    MeanAveragePrecision,
)
from analytics_zoo_torch.models.image.objectdetection.detector import (
    ObjectDetector,
)

__all__ = [
    "decode_boxes", "encode_boxes", "iou_matrix", "nms", "ssd_priors",
    "MultiBoxLoss", "match_priors", "multiclass_nms",
    "SSDDetector", "ssd_lite",
    "ssd_vgg300", "MeanAveragePrecision", "ObjectDetector",
]
