"""Device selection and the kernels' build."""
