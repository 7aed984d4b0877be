"""Host-side native runtime of the port (the C++ ESDF)."""
