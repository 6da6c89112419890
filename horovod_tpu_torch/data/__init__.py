"""Data-loading utilities (port of ``horovod_tpu/data/``; reference:
horovod/data/__init__.py)."""

from .data_loader_base import (AsyncDataLoaderMixin,  # noqa: F401
                               BaseDataLoader, prefetch_to_device)
