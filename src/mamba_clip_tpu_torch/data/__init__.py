"""Host-side data: the ISIC-2024 and synthetic datasets, the loader,
metadata and sampling, report generation and the tokenizers."""

from .dataset import IsicChallengeDataset, SyntheticIsicDataset, synthetic_metadata
from .loader import BatchLoader, DataInfo, device_prefetch, get_data
from .metadata import (
    balanced_class_weights,
    class_counts,
    get_metadata,
    train_test_split,
    undersample_data,
)
from .preprocess_cfg import TransformConfig, get_transform_config
from .report_gen import generate_report, generate_report_v2
from .sampling import (
    combo_epoch_indices,
    epoch_indices,
    sample_weights,
    sampling_probabilities,
    weighted_epoch_indices,
)
from .tokenizer import HashTokenizer, HFTokenizerAdapter, get_tokenizer

__all__ = [
    "IsicChallengeDataset", "SyntheticIsicDataset", "synthetic_metadata",
    "BatchLoader", "DataInfo", "device_prefetch", "get_data",
    "get_metadata", "train_test_split", "undersample_data",
    "balanced_class_weights", "class_counts",
    "TransformConfig", "get_transform_config",
    "generate_report", "generate_report_v2",
    "sampling_probabilities", "sample_weights", "epoch_indices",
    "weighted_epoch_indices", "combo_epoch_indices",
    "HashTokenizer", "HFTokenizerAdapter", "get_tokenizer",
]
