"""nerfbench's drivers (see ../README.md)."""
