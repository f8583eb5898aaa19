"""Device selection and parameter conversion helpers."""
