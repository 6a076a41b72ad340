"""Search models of the port: the device index, the traversal loop, entry
selection and the in-memory and exact-distance variants."""
