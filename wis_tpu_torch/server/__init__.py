"""Host-side services of the port that need no HTTP framework."""
