"""The benchmark's plain reference: what decides `correct`."""
