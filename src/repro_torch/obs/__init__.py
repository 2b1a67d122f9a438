"""On-device metric pack of the DSM outer step."""
