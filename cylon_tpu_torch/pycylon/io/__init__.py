from .csv_read_config import CSVReadOptions

__all__ = ["CSVReadOptions"]
