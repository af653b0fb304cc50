from .DataManager import (DataLoader, DistributedDataLoader, LocalDataLoader,
                          MiniBatcher, Partition)

__all__ = ["DataLoader", "LocalDataLoader", "DistributedDataLoader",
           "MiniBatcher", "Partition"]
