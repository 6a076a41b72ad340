"""Search models of the port: the device index, the traversal loop and the
in-memory variant."""
