"""Host and device helpers shared by the port's render paths."""
