"""Host-side data: KITTI label records and target builders."""
