"""Model families of the port (SD-1.5 so far) and their shared blocks."""
