"""The port's benchmark: run.py runs one cell; see README.md."""
