"""Scene and input-file readers and writers."""
