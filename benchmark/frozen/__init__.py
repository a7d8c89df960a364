"""Frozen copies of pieces of the port and of its tools that the
benchmark uses as its yardstick; each file names the commit it was copied
from."""
