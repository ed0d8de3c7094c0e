from analytics_zoo_torch.models.image.imageclassification.nets import (
    ImageClassifier, alexnet, densenet, inception_v1, lenet, load_pretrained,
    mobilenet, pretrained_configure, resnet, squeezenet, vgg,
)

__all__ = ["ImageClassifier", "alexnet", "densenet", "inception_v1",
           "lenet", "load_pretrained", "mobilenet", "pretrained_configure",
           "resnet", "squeezenet", "vgg"]
