"""Traffic generators, one module a kind, named by a traffic file's `generator`."""
