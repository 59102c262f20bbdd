"""Experimental subsystems (the reference's experimental/ tree)."""
