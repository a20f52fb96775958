"""Physics modules of the port (host tables that feed the device solves)."""
