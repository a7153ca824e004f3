"""Host-side audio loading."""
