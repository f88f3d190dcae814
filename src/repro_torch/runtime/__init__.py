"""Device selection and timing (counterpart of ``repro.runtime``)."""
