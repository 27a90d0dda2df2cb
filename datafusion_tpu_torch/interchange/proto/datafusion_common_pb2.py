# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: datafusion_common.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x17\x64\x61tafusion_common.proto\x12\x11\x64\x61tafusion_common\"\"\n\x0e\x43olumnRelation\x12\x10\n\x08relation\x18\x01 \x01(\t\"K\n\x06\x43olumn\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x33\n\x08relation\x18\x02 \x01(\x0b\x32!.datafusion_common.ColumnRelation\"h\n\x07\x44\x66\x46ield\x12\'\n\x05\x66ield\x18\x01 \x01(\x0b\x32\x18.datafusion_common.Field\x12\x34\n\tqualifier\x18\x02 \x01(\x0b\x32!.datafusion_common.ColumnRelation\"\xa5\x01\n\x08\x44\x66Schema\x12+\n\x07\x63olumns\x18\x01 \x03(\x0b\x32\x1a.datafusion_common.DfField\x12;\n\x08metadata\x18\x02 \x03(\x0b\x32).datafusion_common.DfSchema.MetadataEntry\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\";\n\tCsvFormat\x12.\n\x07options\x18\x05 \x01(\x0b\x32\x1d.datafusion_common.CsvOptions\"N\n\rParquetFormat\x12\x37\n\x07options\x18\x02 \x01(\x0b\x32&.datafusion_common.TableParquetOptionsJ\x04\x08\x01\x10\x02\"\x0c\n\nAvroFormat\"?\n\x0cNdJsonFormat\x12/\n\x07options\x18\x01 \x01(\x0b\x32\x1e.datafusion_common.JsonOptions\"\r\n\x0b\x41rrowFormat\"\'\n\x14PrimaryKeyConstraint\x12\x0f\n\x07indices\x18\x01 \x03(\x04\"#\n\x10UniqueConstraint\x12\x0f\n\x07indices\x18\x01 \x03(\x04\"\x96\x01\n\nConstraint\x12>\n\x0bprimary_key\x18\x01 \x01(\x0b\x32\'.datafusion_common.PrimaryKeyConstraintH\x00\x12\x35\n\x06unique\x18\x02 \x01(\x0b\x32#.datafusion_common.UniqueConstraintH\x00\x42\x11\n\x0f\x63onstraint_mode\"A\n\x0b\x43onstraints\x12\x32\n\x0b\x63onstraints\x18\x01 \x03(\x0b\x32\x1d.datafusion_common.Constraint\"\r\n\x0b\x41vroOptions\"\x0e\n\x0c\x41rrowOptions\"\x9f\x01\n\x06Schema\x12)\n\x07\x63olumns\x18\x01 \x03(\x0b\x32\x18.datafusion_common.Field\x12\x39\n\x08metadata\x18\x02 \x03(\x0b\x32\'.datafusion_common.Schema.MetadataEntry\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xf0\x01\n\x05\x46ield\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x30\n\narrow_type\x18\x02 \x01(\x0b\x32\x1c.datafusion_common.ArrowType\x12\x10\n\x08nullable\x18\x03 \x01(\x08\x12*\n\x08\x63hildren\x18\x04 \x03(\x0b\x32\x18.datafusion_common.Field\x12\x38\n\x08metadata\x18\x05 \x03(\x0b\x32&.datafusion_common.Field.MetadataEntry\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"M\n\tTimestamp\x12.\n\ttime_unit\x18\x01 \x01(\x0e\x32\x1b.datafusion_common.TimeUnit\x12\x10\n\x08timezone\x18\x02 \x01(\t\"=\n\rDecimal32Type\x12\x11\n\tprecision\x18\x03 \x01(\r\x12\r\n\x05scale\x18\x04 \x01(\x05J\x04\x08\x01\x10\x02J\x04\x08\x02\x10\x03\"=\n\rDecimal64Type\x12\x11\n\tprecision\x18\x03 \x01(\r\x12\r\n\x05scale\x18\x04 \x01(\x05J\x04\x08\x01\x10\x02J\x04\x08\x02\x10\x03\">\n\x0e\x44\x65\x63imal128Type\x12\x11\n\tprecision\x18\x03 \x01(\r\x12\r\n\x05scale\x18\x04 \x01(\x05J\x04\x08\x01\x10\x02J\x04\x08\x02\x10\x03\">\n\x0e\x44\x65\x63imal256Type\x12\x11\n\tprecision\x18\x03 \x01(\r\x12\r\n\x05scale\x18\x04 \x01(\x05J\x04\x08\x01\x10\x02J\x04\x08\x02\x10\x03\"4\n\x04List\x12,\n\nfield_type\x18\x01 \x01(\x0b\x32\x18.datafusion_common.Field\"P\n\rFixedSizeList\x12,\n\nfield_type\x18\x01 \x01(\x0b\x32\x18.datafusion_common.Field\x12\x11\n\tlist_size\x18\x02 \x01(\x05\"d\n\nDictionary\x12)\n\x03key\x18\x01 \x01(\x0b\x32\x1c.datafusion_common.ArrowType\x12+\n\x05value\x18\x02 \x01(\x0b\x32\x1c.datafusion_common.ArrowType\";\n\x06Struct\x12\x31\n\x0fsub_field_types\x18\x01 \x03(\x0b\x32\x18.datafusion_common.Field\"H\n\x03Map\x12,\n\nfield_type\x18\x01 \x01(\x0b\x32\x18.datafusion_common.Field\x12\x13\n\x0bkeys_sorted\x18\x02 \x01(\x08\"q\n\rRunEndEncoded\x12\x30\n\x0erun_ends_field\x18\x01 \x01(\x0b\x32\x18.datafusion_common.Field\x12.\n\x0cvalues_field\x18\x02 \x01(\x0b\x32\x18.datafusion_common.Field\"z\n\x05Union\x12-\n\x0bunion_types\x18\x01 \x03(\x0b\x32\x18.datafusion_common.Field\x12\x30\n\nunion_mode\x18\x02 \x01(\x0e\x32\x1c.datafusion_common.UnionMode\x12\x10\n\x08type_ids\x18\x03 \x03(\x05\"\xe5\x01\n\x11ScalarNestedValue\x12\x13\n\x0bipc_message\x18\x01 \x01(\x0c\x12\x12\n\narrow_data\x18\x02 \x01(\x0c\x12)\n\x06schema\x18\x03 \x01(\x0b\x32\x19.datafusion_common.Schema\x12\x45\n\x0c\x64ictionaries\x18\x04 \x03(\x0b\x32/.datafusion_common.ScalarNestedValue.Dictionary\x1a\x35\n\nDictionary\x12\x13\n\x0bipc_message\x18\x01 \x01(\x0c\x12\x12\n\narrow_data\x18\x02 \x01(\x0c\"_\n\x11ScalarTime32Value\x12\x1d\n\x13time32_second_value\x18\x01 \x01(\x05H\x00\x12\"\n\x18time32_millisecond_value\x18\x02 \x01(\x05H\x00\x42\x07\n\x05value\"c\n\x11ScalarTime64Value\x12\"\n\x18time64_microsecond_value\x18\x01 \x01(\x03H\x00\x12!\n\x17time64_nanosecond_value\x18\x02 \x01(\x03H\x00\x42\x07\n\x05value\"\xb3\x01\n\x14ScalarTimestampValue\x12 \n\x16time_microsecond_value\x18\x01 \x01(\x03H\x00\x12\x1f\n\x15time_nanosecond_value\x18\x02 \x01(\x03H\x00\x12\x1b\n\x11time_second_value\x18\x03 \x01(\x03H\x00\x12 \n\x16time_millisecond_value\x18\x04 \x01(\x03H\x00\x12\x10\n\x08timezone\x18\x05 \x01(\tB\x07\n\x05value\"x\n\x15ScalarDictionaryValue\x12\x30\n\nindex_type\x18\x01 \x01(\x0b\x32\x1c.datafusion_common.ArrowType\x12-\n\x05value\x18\x02 \x01(\x0b\x32\x1e.datafusion_common.ScalarValue\"\xab\x01\n\x18ScalarRunEndEncodedValue\x12\x30\n\x0erun_ends_field\x18\x01 \x01(\x0b\x32\x18.datafusion_common.Field\x12.\n\x0cvalues_field\x18\x02 \x01(\x0b\x32\x18.datafusion_common.Field\x12-\n\x05value\x18\x03 \x01(\x0b\x32\x1e.datafusion_common.ScalarValue\":\n\x14IntervalDayTimeValue\x12\x0c\n\x04\x64\x61ys\x18\x01 \x01(\x05\x12\x14\n\x0cmilliseconds\x18\x02 \x01(\x05\"H\n\x19IntervalMonthDayNanoValue\x12\x0e\n\x06months\x18\x01 \x01(\x05\x12\x0c\n\x04\x64\x61ys\x18\x02 \x01(\x05\x12\r\n\x05nanos\x18\x03 \x01(\x03\"G\n\nUnionField\x12\x10\n\x08\x66ield_id\x18\x01 \x01(\x05\x12\'\n\x05\x66ield\x18\x02 \x01(\x0b\x32\x18.datafusion_common.Field\"\xa8\x01\n\nUnionValue\x12\x10\n\x08value_id\x18\x01 \x01(\x05\x12-\n\x05value\x18\x02 \x01(\x0b\x32\x1e.datafusion_common.ScalarValue\x12-\n\x06\x66ields\x18\x03 \x03(\x0b\x32\x1d.datafusion_common.UnionField\x12*\n\x04mode\x18\x04 \x01(\x0e\x32\x1c.datafusion_common.UnionMode\"7\n\x15ScalarFixedSizeBinary\x12\x0e\n\x06values\x18\x01 \x01(\x0c\x12\x0e\n\x06length\x18\x02 \x01(\x05\"\xfb\x0f\n\x0bScalarValue\x12\x32\n\nnull_value\x18! \x01(\x0b\x32\x1c.datafusion_common.ArrowTypeH\x00\x12\x14\n\nbool_value\x18\x01 \x01(\x08H\x00\x12\x14\n\nutf8_value\x18\x02 \x01(\tH\x00\x12\x1a\n\x10large_utf8_value\x18\x03 \x01(\tH\x00\x12\x19\n\x0futf8_view_value\x18\x17 \x01(\tH\x00\x12\x14\n\nint8_value\x18\x04 \x01(\x05H\x00\x12\x15\n\x0bint16_value\x18\x05 \x01(\x05H\x00\x12\x15\n\x0bint32_value\x18\x06 \x01(\x05H\x00\x12\x15\n\x0bint64_value\x18\x07 \x01(\x03H\x00\x12\x15\n\x0buint8_value\x18\x08 \x01(\rH\x00\x12\x16\n\x0cuint16_value\x18\t \x01(\rH\x00\x12\x16\n\x0cuint32_value\x18\n \x01(\rH\x00\x12\x16\n\x0cuint64_value\x18\x0b \x01(\x04H\x00\x12\x17\n\rfloat32_value\x18\x0c \x01(\x02H\x00\x12\x17\n\rfloat64_value\x18\r \x01(\x01H\x00\x12\x17\n\rdate_32_value\x18\x0e \x01(\x05H\x00\x12<\n\x0ctime32_value\x18\x0f \x01(\x0b\x32$.datafusion_common.ScalarTime32ValueH\x00\x12@\n\x10large_list_value\x18\x10 \x01(\x0b\x32$.datafusion_common.ScalarNestedValueH\x00\x12:\n\nlist_value\x18\x11 \x01(\x0b\x32$.datafusion_common.ScalarNestedValueH\x00\x12\x45\n\x15\x66ixed_size_list_value\x18\x12 \x01(\x0b\x32$.datafusion_common.ScalarNestedValueH\x00\x12?\n\x0flist_view_value\x18. \x01(\x0b\x32$.datafusion_common.ScalarNestedValueH\x00\x12\x45\n\x15large_list_view_value\x18/ \x01(\x0b\x32$.datafusion_common.ScalarNestedValueH\x00\x12<\n\x0cstruct_value\x18  \x01(\x0b\x32$.datafusion_common.ScalarNestedValueH\x00\x12\x39\n\tmap_value\x18) \x01(\x0b\x32$.datafusion_common.ScalarNestedValueH\x00\x12\x37\n\x0f\x64\x65\x63imal32_value\x18+ \x01(\x0b\x32\x1c.datafusion_common.Decimal32H\x00\x12\x37\n\x0f\x64\x65\x63imal64_value\x18, \x01(\x0b\x32\x1c.datafusion_common.Decimal64H\x00\x12\x39\n\x10\x64\x65\x63imal128_value\x18\x14 \x01(\x0b\x32\x1d.datafusion_common.Decimal128H\x00\x12\x39\n\x10\x64\x65\x63imal256_value\x18\' \x01(\x0b\x32\x1d.datafusion_common.Decimal256H\x00\x12\x17\n\rdate_64_value\x18\x15 \x01(\x03H\x00\x12\"\n\x18interval_yearmonth_value\x18\x18 \x01(\x05H\x00\x12\x1f\n\x15\x64uration_second_value\x18# \x01(\x03H\x00\x12$\n\x1a\x64uration_millisecond_value\x18$ \x01(\x03H\x00\x12$\n\x1a\x64uration_microsecond_value\x18% \x01(\x03H\x00\x12#\n\x19\x64uration_nanosecond_value\x18& \x01(\x03H\x00\x12\x42\n\x0ftimestamp_value\x18\x1a \x01(\x0b\x32\'.datafusion_common.ScalarTimestampValueH\x00\x12\x44\n\x10\x64ictionary_value\x18\x1b \x01(\x0b\x32(.datafusion_common.ScalarDictionaryValueH\x00\x12\x16\n\x0c\x62inary_value\x18\x1c \x01(\x0cH\x00\x12\x1c\n\x12large_binary_value\x18\x1d \x01(\x0cH\x00\x12\x1b\n\x11\x62inary_view_value\x18\x16 \x01(\x0cH\x00\x12<\n\x0ctime64_value\x18\x1e \x01(\x0b\x32$.datafusion_common.ScalarTime64ValueH\x00\x12I\n\x16interval_daytime_value\x18\x19 \x01(\x0b\x32\'.datafusion_common.IntervalDayTimeValueH\x00\x12O\n\x17interval_month_day_nano\x18\x1f \x01(\x0b\x32,.datafusion_common.IntervalMonthDayNanoValueH\x00\x12K\n\x17\x66ixed_size_binary_value\x18\" \x01(\x0b\x32(.datafusion_common.ScalarFixedSizeBinaryH\x00\x12\x34\n\x0bunion_value\x18* \x01(\x0b\x32\x1d.datafusion_common.UnionValueH\x00\x12L\n\x15run_end_encoded_value\x18- \x01(\x0b\x32+.datafusion_common.ScalarRunEndEncodedValueH\x00\x42\x07\n\x05valueJ\x04\x08\x13\x10\x14\"0\n\tDecimal32\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\t\n\x01p\x18\x02 \x01(\x03\x12\t\n\x01s\x18\x03 \x01(\x03\"0\n\tDecimal64\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\t\n\x01p\x18\x02 \x01(\x03\x12\t\n\x01s\x18\x03 \x01(\x03\"1\n\nDecimal128\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\t\n\x01p\x18\x02 \x01(\x03\x12\t\n\x01s\x18\x03 \x01(\x03\"1\n\nDecimal256\x12\r\n\x05value\x18\x01 \x01(\x0c\x12\t\n\x01p\x18\x02 \x01(\x03\x12\t\n\x01s\x18\x03 \x01(\x03\"\xb2\x10\n\tArrowType\x12/\n\x04NONE\x18\x01 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12/\n\x04\x42OOL\x18\x02 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x30\n\x05UINT8\x18\x03 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12/\n\x04INT8\x18\x04 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x31\n\x06UINT16\x18\x05 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x30\n\x05INT16\x18\x06 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x31\n\x06UINT32\x18\x07 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x30\n\x05INT32\x18\x08 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x31\n\x06UINT64\x18\t \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x30\n\x05INT64\x18\n \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x32\n\x07\x46LOAT16\x18\x0b \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x32\n\x07\x46LOAT32\x18\x0c \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x32\n\x07\x46LOAT64\x18\r \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12/\n\x04UTF8\x18\x0e \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x34\n\tUTF8_VIEW\x18# \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x35\n\nLARGE_UTF8\x18  \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x31\n\x06\x42INARY\x18\x0f \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x36\n\x0b\x42INARY_VIEW\x18\" \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x1b\n\x11\x46IXED_SIZE_BINARY\x18\x10 \x01(\x05H\x00\x12\x37\n\x0cLARGE_BINARY\x18\x1f \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x31\n\x06\x44\x41TE32\x18\x11 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12\x31\n\x06\x44\x41TE64\x18\x12 \x01(\x0b\x32\x1f.datafusion_common.EmptyMessageH\x00\x12/\n\x08\x44URATION\x18\x13 \x01(\x0e\x32\x1b.datafusion_common.TimeUnitH\x00\x12\x31\n\tTIMESTAMP\x18\x14 \x01(\x0b\x32\x1c.datafusion_common.TimestampH\x00\x12-\n\x06TIME32\x18\x15 \x01(\x0e\x32\x1b.datafusion_common.TimeUnitH\x00\x12-\n\x06TIME64\x18\x16 \x01(\x0e\x32\x1b.datafusion_common.TimeUnitH\x00\x12\x33\n\x08INTERVAL\x18\x17 \x01(\x0e\x32\x1f.datafusion_common.IntervalUnitH\x00\x12\x35\n\tDECIMAL32\x18( \x01(\x0b\x32 .datafusion_common.Decimal32TypeH\x00\x12\x35\n\tDECIMAL64\x18) \x01(\x0b\x32 .datafusion_common.Decimal64TypeH\x00\x12\x37\n\nDECIMAL128\x18\x18 \x01(\x0b\x32!.datafusion_common.Decimal128TypeH\x00\x12\x37\n\nDECIMAL256\x18$ \x01(\x0b\x32!.datafusion_common.Decimal256TypeH\x00\x12\'\n\x04LIST\x18\x19 \x01(\x0b\x32\x17.datafusion_common.ListH\x00\x12-\n\nLARGE_LIST\x18\x1a \x01(\x0b\x32\x17.datafusion_common.ListH\x00\x12;\n\x0f\x46IXED_SIZE_LIST\x18\x1b \x01(\x0b\x32 .datafusion_common.FixedSizeListH\x00\x12,\n\tLIST_VIEW\x18+ \x01(\x0b\x32\x17.datafusion_common.ListH\x00\x12\x32\n\x0fLARGE_LIST_VIEW\x18, \x01(\x0b\x32\x17.datafusion_common.ListH\x00\x12+\n\x06STRUCT\x18\x1c \x01(\x0b\x32\x19.datafusion_common.StructH\x00\x12)\n\x05UNION\x18\x1d \x01(\x0b\x32\x18.datafusion_common.UnionH\x00\x12\x33\n\nDICTIONARY\x18\x1e \x01(\x0b\x32\x1d.datafusion_common.DictionaryH\x00\x12%\n\x03MAP\x18! \x01(\x0b\x32\x16.datafusion_common.MapH\x00\x12;\n\x0fRUN_END_ENCODED\x18* \x01(\x0b\x32 .datafusion_common.RunEndEncodedH\x00\x42\x11\n\x0f\x61rrow_type_enum\"\x0e\n\x0c\x45mptyMessage\"S\n\x11JsonWriterOptions\x12>\n\x0b\x63ompression\x18\x01 \x01(\x0e\x32).datafusion_common.CompressionTypeVariant\"\x9d\x03\n\x10\x43svWriterOptions\x12>\n\x0b\x63ompression\x18\x01 \x01(\x0e\x32).datafusion_common.CompressionTypeVariant\x12\x11\n\tdelimiter\x18\x02 \x01(\t\x12\x12\n\nhas_header\x18\x03 \x01(\x08\x12\x13\n\x0b\x64\x61te_format\x18\x04 \x01(\t\x12\x17\n\x0f\x64\x61tetime_format\x18\x05 \x01(\t\x12\x18\n\x10timestamp_format\x18\x06 \x01(\t\x12\x13\n\x0btime_format\x18\x07 \x01(\t\x12\x12\n\nnull_value\x18\x08 \x01(\t\x12\r\n\x05quote\x18\t \x01(\t\x12\x0e\n\x06\x65scape\x18\n \x01(\t\x12\x14\n\x0c\x64ouble_quote\x18\x0b \x01(\x08\x12\x35\n\x0bquote_style\x18\x0c \x01(\x0e\x32 .datafusion_common.CsvQuoteStyle\x12!\n\x19ignore_leading_whitespace\x18\r \x01(\x08\x12\"\n\x1aignore_trailing_whitespace\x18\x0e \x01(\x08\"\x93\x05\n\nCsvOptions\x12\x12\n\nhas_header\x18\x01 \x01(\x0c\x12\x11\n\tdelimiter\x18\x02 \x01(\x0c\x12\r\n\x05quote\x18\x03 \x01(\x0c\x12\x0e\n\x06\x65scape\x18\x04 \x01(\x0c\x12>\n\x0b\x63ompression\x18\x05 \x01(\x0e\x32).datafusion_common.CompressionTypeVariant\x12!\n\x14schema_infer_max_rec\x18\x06 \x01(\x04H\x00\x88\x01\x01\x12\x13\n\x0b\x64\x61te_format\x18\x07 \x01(\t\x12\x17\n\x0f\x64\x61tetime_format\x18\x08 \x01(\t\x12\x18\n\x10timestamp_format\x18\t \x01(\t\x12\x1b\n\x13timestamp_tz_format\x18\n \x01(\t\x12\x13\n\x0btime_format\x18\x0b \x01(\t\x12\x12\n\nnull_value\x18\x0c \x01(\t\x12\x12\n\nnull_regex\x18\r \x01(\t\x12\x0f\n\x07\x63omment\x18\x0e \x01(\x0c\x12\x14\n\x0c\x64ouble_quote\x18\x0f \x01(\x0c\x12\x1a\n\x12newlines_in_values\x18\x10 \x01(\x0c\x12\x12\n\nterminator\x18\x11 \x01(\x0c\x12\x16\n\x0etruncated_rows\x18\x12 \x01(\x0c\x12\x1e\n\x11\x63ompression_level\x18\x13 \x01(\rH\x01\x88\x01\x01\x12\x35\n\x0bquote_style\x18\x14 \x01(\x0e\x32 .datafusion_common.CsvQuoteStyle\x12!\n\x19ignore_leading_whitespace\x18\x15 \x01(\x0c\x12\"\n\x1aignore_trailing_whitespace\x18\x16 \x01(\x0c\x42\x17\n\x15_schema_infer_max_recB\x14\n\x12_compression_level\"\xf5\x01\n\x0bJsonOptions\x12>\n\x0b\x63ompression\x18\x01 \x01(\x0e\x32).datafusion_common.CompressionTypeVariant\x12!\n\x14schema_infer_max_rec\x18\x02 \x01(\x04H\x00\x88\x01\x01\x12\x1e\n\x11\x63ompression_level\x18\x03 \x01(\rH\x01\x88\x01\x01\x12\x1e\n\x11newline_delimited\x18\x04 \x01(\x08H\x02\x88\x01\x01\x42\x17\n\x15_schema_infer_max_recB\x14\n\x12_compression_levelB\x14\n\x12_newline_delimited\"\xad\x02\n\x13TableParquetOptions\x12\x31\n\x06global\x18\x01 \x01(\x0b\x32!.datafusion_common.ParquetOptions\x12P\n\x17\x63olumn_specific_options\x18\x02 \x03(\x0b\x32/.datafusion_common.ParquetColumnSpecificOptions\x12X\n\x12key_value_metadata\x18\x03 \x03(\x0b\x32<.datafusion_common.TableParquetOptions.KeyValueMetadataEntry\x1a\x37\n\x15KeyValueMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"m\n\x1cParquetColumnSpecificOptions\x12\x13\n\x0b\x63olumn_name\x18\x01 \x01(\t\x12\x38\n\x07options\x18\x02 \x01(\x0b\x32\'.datafusion_common.ParquetColumnOptions\"\xfe\x02\n\x14ParquetColumnOptions\x12\x1e\n\x14\x62loom_filter_enabled\x18\x01 \x01(\x08H\x00\x12\x12\n\x08\x65ncoding\x18\x02 \x01(\tH\x01\x12\x1c\n\x12\x64ictionary_enabled\x18\x03 \x01(\x08H\x02\x12\x15\n\x0b\x63ompression\x18\x04 \x01(\tH\x03\x12\x1c\n\x12statistics_enabled\x18\x05 \x01(\tH\x04\x12\x1a\n\x10\x62loom_filter_fpp\x18\x06 \x01(\x01H\x05\x12\x1a\n\x10\x62loom_filter_ndv\x18\x07 \x01(\x04H\x06\x42\x1a\n\x18\x62loom_filter_enabled_optB\x0e\n\x0c\x65ncoding_optB\x18\n\x16\x64ictionary_enabled_optB\x11\n\x0f\x63ompression_optB\x18\n\x16statistics_enabled_optB\x16\n\x14\x62loom_filter_fpp_optB\x16\n\x14\x62loom_filter_ndv_optJ\x04\x08\x08\x10\t\"\xbf\x0b\n\x0eParquetOptions\x12\x19\n\x11\x65nable_page_index\x18\x01 \x01(\x08\x12\x0f\n\x07pruning\x18\x02 \x01(\x08\x12\x15\n\rskip_metadata\x18\x03 \x01(\x08\x12\x18\n\x10pushdown_filters\x18\x05 \x01(\x08\x12\x17\n\x0freorder_filters\x18\x06 \x01(\x08\x12\x1f\n\x17\x66orce_filter_selections\x18\" \x01(\x08\x12\x1b\n\x13\x64\x61ta_pagesize_limit\x18\x07 \x01(\x04\x12\x18\n\x10write_batch_size\x18\x08 \x01(\x04\x12\x16\n\x0ewriter_version\x18\t \x01(\t\x12%\n\x1d\x61llow_single_file_parallelism\x18\x17 \x01(\x08\x12*\n\"maximum_parallel_row_group_writers\x18\x18 \x01(\x04\x12\x32\n*maximum_buffered_record_batches_per_stream\x18\x19 \x01(\x04\x12\x1c\n\x14\x62loom_filter_on_read\x18\x1a \x01(\x08\x12\x1d\n\x15\x62loom_filter_on_write\x18\x1b \x01(\x08\x12\x1f\n\x17schema_force_view_types\x18\x1c \x01(\x08\x12\x18\n\x10\x62inary_as_string\x18\x1d \x01(\x08\x12\x1b\n\x13skip_arrow_metadata\x18\x1e \x01(\x08\x12\x1c\n\x12metadata_size_hint\x18\x04 \x01(\x04H\x00\x12\x15\n\x0b\x63ompression\x18\n \x01(\tH\x01\x12\x1c\n\x12\x64ictionary_enabled\x18\x0b \x01(\x08H\x02\x12\x1c\n\x12statistics_enabled\x18\r \x01(\tH\x03\x12&\n\x1c\x63olumn_index_truncate_length\x18\x11 \x01(\x04H\x04\x12$\n\x1astatistics_truncate_length\x18\x1f \x01(\x04H\x05\x12\x12\n\x08\x65ncoding\x18\x13 \x01(\tH\x06\x12\x1a\n\x10\x62loom_filter_fpp\x18\x15 \x01(\x01H\x07\x12\x1a\n\x10\x62loom_filter_ndv\x18\x16 \x01(\x04H\x08\x12\"\n\x1a\x64ictionary_page_size_limit\x18\x0c \x01(\x04\x12!\n\x19\x64\x61ta_page_row_count_limit\x18\x12 \x01(\x04\x12\x1a\n\x12max_row_group_size\x18\x0f \x01(\x04\x12\x18\n\x10max_in_list_size\x18& \x01(\x04\x12\x12\n\ncreated_by\x18\x10 \x01(\t\x12\x16\n\x0c\x63oerce_int96\x18  \x01(\tH\t\x12\"\n\x18max_predicate_cache_size\x18! \x01(\x04H\n\x12\x1d\n\x13max_row_group_bytes\x18% \x01(\x04H\x0b\x12\x46\n\x18\x63ontent_defined_chunking\x18# \x01(\x0b\x32$.datafusion_common.ParquetCdcOptions\x12\x19\n\x0f\x63oerce_int96_tz\x18$ \x01(\tH\x0c\x42\x18\n\x16metadata_size_hint_optB\x11\n\x0f\x63ompression_optB\x18\n\x16\x64ictionary_enabled_optB\x18\n\x16statistics_enabled_optB\"\n column_index_truncate_length_optB \n\x1estatistics_truncate_length_optB\x0e\n\x0c\x65ncoding_optB\x16\n\x14\x62loom_filter_fpp_optB\x16\n\x14\x62loom_filter_ndv_optB\x12\n\x10\x63oerce_int96_optB\x1e\n\x1cmax_predicate_cache_size_optB\x19\n\x17max_row_group_bytes_optB\x15\n\x13\x63oerce_int96_tz_optJ\x04\x08\x0e\x10\x0f\"h\n\x11ParquetCdcOptions\x12\x0f\n\x07\x65nabled\x18\x01 \x01(\x08\x12\x16\n\x0emin_chunk_size\x18\x02 \x01(\x04\x12\x16\n\x0emax_chunk_size\x18\x03 \x01(\x04\x12\x12\n\nnorm_level\x18\x04 \x01(\x05\"r\n\tPrecision\x12\x38\n\x0eprecision_info\x18\x01 \x01(\x0e\x32 .datafusion_common.PrecisionInfo\x12+\n\x03val\x18\x02 \x01(\x0b\x32\x1e.datafusion_common.ScalarValue\"\xaf\x01\n\nStatistics\x12.\n\x08num_rows\x18\x01 \x01(\x0b\x32\x1c.datafusion_common.Precision\x12\x35\n\x0ftotal_byte_size\x18\x02 \x01(\x0b\x32\x1c.datafusion_common.Precision\x12\x34\n\x0c\x63olumn_stats\x18\x03 \x03(\x0b\x32\x1e.datafusion_common.ColumnStatsJ\x04\x08\x04\x10\x05\"\xb9\x02\n\x0b\x43olumnStats\x12/\n\tmin_value\x18\x01 \x01(\x0b\x32\x1c.datafusion_common.Precision\x12/\n\tmax_value\x18\x02 \x01(\x0b\x32\x1c.datafusion_common.Precision\x12/\n\tsum_value\x18\x05 \x01(\x0b\x32\x1c.datafusion_common.Precision\x12\x30\n\nnull_count\x18\x03 \x01(\x0b\x32\x1c.datafusion_common.Precision\x12\x34\n\x0e\x64istinct_count\x18\x04 \x01(\x0b\x32\x1c.datafusion_common.Precision\x12/\n\tbyte_size\x18\x06 \x01(\x0b\x32\x1c.datafusion_common.Precision\"\\\n\x1c\x45xplainAnalyzeCategoriesNode\x12\x0b\n\x03\x61ll\x18\x01 \x01(\x08\x12/\n\x04only\x18\x02 \x03(\x0e\x32!.datafusion_common.MetricCategory*\x8b\x01\n\x08JoinType\x12\t\n\x05INNER\x10\x00\x12\x08\n\x04LEFT\x10\x01\x12\t\n\x05RIGHT\x10\x02\x12\x08\n\x04\x46ULL\x10\x03\x12\x0c\n\x08LEFTSEMI\x10\x04\x12\x0c\n\x08LEFTANTI\x10\x05\x12\r\n\tRIGHTSEMI\x10\x06\x12\r\n\tRIGHTANTI\x10\x07\x12\x0c\n\x08LEFTMARK\x10\x08\x12\r\n\tRIGHTMARK\x10\t*#\n\x0eJoinConstraint\x12\x06\n\x02ON\x10\x00\x12\t\n\x05USING\x10\x01*=\n\x0cNullEquality\x12\x17\n\x13NULL_EQUALS_NOTHING\x10\x00\x12\x14\n\x10NULL_EQUALS_NULL\x10\x01*H\n\x08TimeUnit\x12\n\n\x06Second\x10\x00\x12\x0f\n\x0bMillisecond\x10\x01\x12\x0f\n\x0bMicrosecond\x10\x02\x12\x0e\n\nNanosecond\x10\x03*<\n\x0cIntervalUnit\x12\r\n\tYearMonth\x10\x00\x12\x0b\n\x07\x44\x61yTime\x10\x01\x12\x10\n\x0cMonthDayNano\x10\x02*\"\n\tUnionMode\x12\n\n\x06sparse\x10\x00\x12\t\n\x05\x64\x65nse\x10\x01*Q\n\x16\x43ompressionTypeVariant\x12\x08\n\x04GZIP\x10\x00\x12\t\n\x05\x42ZIP2\x10\x01\x12\x06\n\x02XZ\x10\x02\x12\x08\n\x04ZSTD\x10\x03\x12\x10\n\x0cUNCOMPRESSED\x10\x04*F\n\rCsvQuoteStyle\x12\r\n\tNECESSARY\x10\x00\x12\n\n\x06\x41LWAYS\x10\x01\x12\x0f\n\x0bNON_NUMERIC\x10\x02\x12\t\n\x05NEVER\x10\x03*3\n\x08JoinSide\x12\r\n\tLEFT_SIDE\x10\x00\x12\x0e\n\nRIGHT_SIDE\x10\x01\x12\x08\n\x04NONE\x10\x02*3\n\rPrecisionInfo\x12\t\n\x05\x45XACT\x10\x00\x12\x0b\n\x07INEXACT\x10\x01\x12\n\n\x06\x41\x42SENT\x10\x02*{\n\rExplainFormat\x12\x19\n\x15\x45XPLAIN_FORMAT_INDENT\x10\x00\x12\x17\n\x13\x45XPLAIN_FORMAT_TREE\x10\x01\x12\x19\n\x15\x45XPLAIN_FORMAT_PGJSON\x10\x02\x12\x1b\n\x17\x45XPLAIN_FORMAT_GRAPHVIZ\x10\x03*:\n\nMetricType\x12\x17\n\x13METRIC_TYPE_SUMMARY\x10\x00\x12\x13\n\x0fMETRIC_TYPE_DEV\x10\x01*\x84\x01\n\x0eMetricCategory\x12\x18\n\x14METRIC_CATEGORY_ROWS\x10\x00\x12\x19\n\x15METRIC_CATEGORY_BYTES\x10\x01\x12\x1a\n\x16METRIC_CATEGORY_TIMING\x10\x02\x12!\n\x1dMETRIC_CATEGORY_UNCATEGORIZED\x10\x03\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'datafusion_common_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DFSCHEMA_METADATAENTRY._options = None
  _DFSCHEMA_METADATAENTRY._serialized_options = b'8\001'
  _SCHEMA_METADATAENTRY._options = None
  _SCHEMA_METADATAENTRY._serialized_options = b'8\001'
  _FIELD_METADATAENTRY._options = None
  _FIELD_METADATAENTRY._serialized_options = b'8\001'
  _TABLEPARQUETOPTIONS_KEYVALUEMETADATAENTRY._options = None
  _TABLEPARQUETOPTIONS_KEYVALUEMETADATAENTRY._serialized_options = b'8\001'
  _JOINTYPE._serialized_start=12551
  _JOINTYPE._serialized_end=12690
  _JOINCONSTRAINT._serialized_start=12692
  _JOINCONSTRAINT._serialized_end=12727
  _NULLEQUALITY._serialized_start=12729
  _NULLEQUALITY._serialized_end=12790
  _TIMEUNIT._serialized_start=12792
  _TIMEUNIT._serialized_end=12864
  _INTERVALUNIT._serialized_start=12866
  _INTERVALUNIT._serialized_end=12926
  _UNIONMODE._serialized_start=12928
  _UNIONMODE._serialized_end=12962
  _COMPRESSIONTYPEVARIANT._serialized_start=12964
  _COMPRESSIONTYPEVARIANT._serialized_end=13045
  _CSVQUOTESTYLE._serialized_start=13047
  _CSVQUOTESTYLE._serialized_end=13117
  _JOINSIDE._serialized_start=13119
  _JOINSIDE._serialized_end=13170
  _PRECISIONINFO._serialized_start=13172
  _PRECISIONINFO._serialized_end=13223
  _EXPLAINFORMAT._serialized_start=13225
  _EXPLAINFORMAT._serialized_end=13348
  _METRICTYPE._serialized_start=13350
  _METRICTYPE._serialized_end=13408
  _METRICCATEGORY._serialized_start=13411
  _METRICCATEGORY._serialized_end=13543
  _COLUMNRELATION._serialized_start=46
  _COLUMNRELATION._serialized_end=80
  _COLUMN._serialized_start=82
  _COLUMN._serialized_end=157
  _DFFIELD._serialized_start=159
  _DFFIELD._serialized_end=263
  _DFSCHEMA._serialized_start=266
  _DFSCHEMA._serialized_end=431
  _DFSCHEMA_METADATAENTRY._serialized_start=384
  _DFSCHEMA_METADATAENTRY._serialized_end=431
  _CSVFORMAT._serialized_start=433
  _CSVFORMAT._serialized_end=492
  _PARQUETFORMAT._serialized_start=494
  _PARQUETFORMAT._serialized_end=572
  _AVROFORMAT._serialized_start=574
  _AVROFORMAT._serialized_end=586
  _NDJSONFORMAT._serialized_start=588
  _NDJSONFORMAT._serialized_end=651
  _ARROWFORMAT._serialized_start=653
  _ARROWFORMAT._serialized_end=666
  _PRIMARYKEYCONSTRAINT._serialized_start=668
  _PRIMARYKEYCONSTRAINT._serialized_end=707
  _UNIQUECONSTRAINT._serialized_start=709
  _UNIQUECONSTRAINT._serialized_end=744
  _CONSTRAINT._serialized_start=747
  _CONSTRAINT._serialized_end=897
  _CONSTRAINTS._serialized_start=899
  _CONSTRAINTS._serialized_end=964
  _AVROOPTIONS._serialized_start=966
  _AVROOPTIONS._serialized_end=979
  _ARROWOPTIONS._serialized_start=981
  _ARROWOPTIONS._serialized_end=995
  _SCHEMA._serialized_start=998
  _SCHEMA._serialized_end=1157
  _SCHEMA_METADATAENTRY._serialized_start=384
  _SCHEMA_METADATAENTRY._serialized_end=431
  _FIELD._serialized_start=1160
  _FIELD._serialized_end=1400
  _FIELD_METADATAENTRY._serialized_start=384
  _FIELD_METADATAENTRY._serialized_end=431
  _TIMESTAMP._serialized_start=1402
  _TIMESTAMP._serialized_end=1479
  _DECIMAL32TYPE._serialized_start=1481
  _DECIMAL32TYPE._serialized_end=1542
  _DECIMAL64TYPE._serialized_start=1544
  _DECIMAL64TYPE._serialized_end=1605
  _DECIMAL128TYPE._serialized_start=1607
  _DECIMAL128TYPE._serialized_end=1669
  _DECIMAL256TYPE._serialized_start=1671
  _DECIMAL256TYPE._serialized_end=1733
  _LIST._serialized_start=1735
  _LIST._serialized_end=1787
  _FIXEDSIZELIST._serialized_start=1789
  _FIXEDSIZELIST._serialized_end=1869
  _DICTIONARY._serialized_start=1871
  _DICTIONARY._serialized_end=1971
  _STRUCT._serialized_start=1973
  _STRUCT._serialized_end=2032
  _MAP._serialized_start=2034
  _MAP._serialized_end=2106
  _RUNENDENCODED._serialized_start=2108
  _RUNENDENCODED._serialized_end=2221
  _UNION._serialized_start=2223
  _UNION._serialized_end=2345
  _SCALARNESTEDVALUE._serialized_start=2348
  _SCALARNESTEDVALUE._serialized_end=2577
  _SCALARNESTEDVALUE_DICTIONARY._serialized_start=2524
  _SCALARNESTEDVALUE_DICTIONARY._serialized_end=2577
  _SCALARTIME32VALUE._serialized_start=2579
  _SCALARTIME32VALUE._serialized_end=2674
  _SCALARTIME64VALUE._serialized_start=2676
  _SCALARTIME64VALUE._serialized_end=2775
  _SCALARTIMESTAMPVALUE._serialized_start=2778
  _SCALARTIMESTAMPVALUE._serialized_end=2957
  _SCALARDICTIONARYVALUE._serialized_start=2959
  _SCALARDICTIONARYVALUE._serialized_end=3079
  _SCALARRUNENDENCODEDVALUE._serialized_start=3082
  _SCALARRUNENDENCODEDVALUE._serialized_end=3253
  _INTERVALDAYTIMEVALUE._serialized_start=3255
  _INTERVALDAYTIMEVALUE._serialized_end=3313
  _INTERVALMONTHDAYNANOVALUE._serialized_start=3315
  _INTERVALMONTHDAYNANOVALUE._serialized_end=3387
  _UNIONFIELD._serialized_start=3389
  _UNIONFIELD._serialized_end=3460
  _UNIONVALUE._serialized_start=3463
  _UNIONVALUE._serialized_end=3631
  _SCALARFIXEDSIZEBINARY._serialized_start=3633
  _SCALARFIXEDSIZEBINARY._serialized_end=3688
  _SCALARVALUE._serialized_start=3691
  _SCALARVALUE._serialized_end=5734
  _DECIMAL32._serialized_start=5736
  _DECIMAL32._serialized_end=5784
  _DECIMAL64._serialized_start=5786
  _DECIMAL64._serialized_end=5834
  _DECIMAL128._serialized_start=5836
  _DECIMAL128._serialized_end=5885
  _DECIMAL256._serialized_start=5887
  _DECIMAL256._serialized_end=5936
  _ARROWTYPE._serialized_start=5939
  _ARROWTYPE._serialized_end=8037
  _EMPTYMESSAGE._serialized_start=8039
  _EMPTYMESSAGE._serialized_end=8053
  _JSONWRITEROPTIONS._serialized_start=8055
  _JSONWRITEROPTIONS._serialized_end=8138
  _CSVWRITEROPTIONS._serialized_start=8141
  _CSVWRITEROPTIONS._serialized_end=8554
  _CSVOPTIONS._serialized_start=8557
  _CSVOPTIONS._serialized_end=9216
  _JSONOPTIONS._serialized_start=9219
  _JSONOPTIONS._serialized_end=9464
  _TABLEPARQUETOPTIONS._serialized_start=9467
  _TABLEPARQUETOPTIONS._serialized_end=9768
  _TABLEPARQUETOPTIONS_KEYVALUEMETADATAENTRY._serialized_start=9713
  _TABLEPARQUETOPTIONS_KEYVALUEMETADATAENTRY._serialized_end=9768
  _PARQUETCOLUMNSPECIFICOPTIONS._serialized_start=9770
  _PARQUETCOLUMNSPECIFICOPTIONS._serialized_end=9879
  _PARQUETCOLUMNOPTIONS._serialized_start=9882
  _PARQUETCOLUMNOPTIONS._serialized_end=10264
  _PARQUETOPTIONS._serialized_start=10267
  _PARQUETOPTIONS._serialized_end=11738
  _PARQUETCDCOPTIONS._serialized_start=11740
  _PARQUETCDCOPTIONS._serialized_end=11844
  _PRECISION._serialized_start=11846
  _PRECISION._serialized_end=11960
  _STATISTICS._serialized_start=11963
  _STATISTICS._serialized_end=12138
  _COLUMNSTATS._serialized_start=12141
  _COLUMNSTATS._serialized_end=12454
  _EXPLAINANALYZECATEGORIESNODE._serialized_start=12456
  _EXPLAINANALYZECATEGORIESNODE._serialized_end=12548
# @@protoc_insertion_point(module_scope)
