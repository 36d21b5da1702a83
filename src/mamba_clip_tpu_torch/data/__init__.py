"""Host-side data configuration."""
