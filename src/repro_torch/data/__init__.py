from repro_torch.data.corpus import (  # noqa: F401
    generate_part,
    extract_postings,
    group_by_key,
)
