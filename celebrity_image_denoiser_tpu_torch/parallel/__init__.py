"""Big inputs on one device: exact overlap tiling (``parallel/tiling.py``).
The mesh paths (spatial sharding, data parallelism) are not ported yet."""
