from . import classifier
from . import classifier_auto
