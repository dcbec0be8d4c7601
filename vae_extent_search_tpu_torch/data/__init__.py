"""Data of the port: the committed featurized candidate pool (``pool.py``),
the synthetic pretraining corpora (``boost_corpus.py``) and the performance
dataset of cost-model training (``dataset.py``)."""

from .dataset import (
    Dataset,
    LearningTask,
    make_dataset_from_log_file,
)
