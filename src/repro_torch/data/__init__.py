from repro_torch.data.libsvm import parse_libsvm, write_libsvm
from repro_torch.data.synthetic import make_synthetic_logreg, DATASET_SHAPES
from repro_torch.data.partition import partition_clients, absorb_labels, add_intercept

__all__ = [
    "parse_libsvm",
    "write_libsvm",
    "make_synthetic_logreg",
    "DATASET_SHAPES",
    "partition_clients",
    "absorb_labels",
    "add_intercept",
]
