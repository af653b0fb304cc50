"""TPC-H on the port: the generator (on the device, with an exact numpy
mirror) and all 22 queries, composed from the distributed operators."""
from .datagen import TABLE_NAMES, date_to_days
from .datagen_device import generate_device, generate_mirror
from .queries import QUERIES

__all__ = ["TABLE_NAMES", "date_to_days", "generate_device",
           "generate_mirror", "QUERIES"]
