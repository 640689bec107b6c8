"""The plain references the benchmark holds the program to."""
