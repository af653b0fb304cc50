"""pycylon.io.csv_read_config over the port — reference:
python/pycylon/io/csv_read_config.pyx (mirror of io/csv_read_config.hpp).
"""
from ...io import CSVReadOptions

__all__ = ["CSVReadOptions"]
