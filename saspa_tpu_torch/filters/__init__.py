from saspa_tpu_torch.filters.aug_json import (
    get_aug_json_path,
    create_json_of_image_name_to_augmented_images_paths,
    merge_aug_jsons,
    merge_aug_jsons_with_amount_per_json,
    remove_all_augs_w_sub_str_and_save,
    get_dict_of_value_counts_image_name_to_num_aug_images,
)
