"""The multi-process runtime (``parallel/distributed.py``)."""
