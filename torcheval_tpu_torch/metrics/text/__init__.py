from torcheval_tpu_torch.metrics.text.bleu import BLEUScore
from torcheval_tpu_torch.metrics.text.perplexity import Perplexity
from torcheval_tpu_torch.metrics.text.word_error_rate import (
    WordErrorRate,
    WordInformationLost,
    WordInformationPreserved,
)

__all__ = [
    "BLEUScore",
    "Perplexity",
    "WordErrorRate",
    "WordInformationLost",
    "WordInformationPreserved",
]
