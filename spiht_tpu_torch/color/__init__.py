from . import models
from .torch_models import SUPPORTED_MODELS, convert
