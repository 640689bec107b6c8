"""Loops, one module a kind, named by a traffic file's `loop`: the loop that
feeds the program and times it."""
