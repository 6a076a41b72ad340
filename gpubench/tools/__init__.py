"""Tools that set a cell's numbers or run its series; no benchmark run
calls them."""
