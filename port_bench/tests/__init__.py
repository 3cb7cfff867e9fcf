"""CPU tests of the port's benchmark (``python -m pytest port_bench/tests``)."""
