"""TPC-H on the port: the host generator (pandas frames, the JAX
package's ``generate``), the device generator with its exact numpy
mirror, and all 22 queries, composed from the distributed operators."""
from .datagen import TABLE_NAMES, date_to_days, generate
from .datagen_device import generate_device, generate_mirror
from .queries import QUERIES

__all__ = ["generate", "TABLE_NAMES", "date_to_days", "generate_device",
           "generate_mirror", "QUERIES"]
