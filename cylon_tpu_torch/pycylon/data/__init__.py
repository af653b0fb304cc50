from .table import Table, csv_reader

__all__ = ["Table", "csv_reader"]
