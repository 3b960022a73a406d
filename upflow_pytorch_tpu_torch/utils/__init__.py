"""Host-side helpers of the port: running meters and a wall clock."""
